"""Process-group parallelism: frame-batch data parallel with an all-reduce of
the metric counts (``mav_detection_tpu.parallel.mesh``).

One process per device. A ``Mesh`` is this process's place in a
``torch.distributed`` group: its rank, the group's size and ranks, and its
device (``cuda:<local rank>``, or the CPU). The backend is NCCL when the
device is the card and gloo only when the caller asks for the CPU; the card
never falls back to gloo.

``launch`` starts the ranks itself when no group exists: ``spawn`` processes
(never ``fork``, which CUDA does not survive), a ``file://`` rendezvous in a
fresh temporary directory (no fixed port, so launches side by side do not
collide), a timeout on the group and a bounded wait for the ranks, so that a
hung rank fails the call instead of hanging it. The caller gets rank 0's
return value (or every rank's). Under a group that exists already (e.g.
started by ``torchrun``), the entry points use it through ``make_mesh``.

A batch is split into contiguous lanes, padded to a multiple of the group's
size by repeating its last lane (``shard_frame_batch``); each rank runs the
detection step on its lanes (``detect_frames_sharded``), and the pixel
TPR/FPR of the whole batch is one ``all_reduce`` of four counts with the
padded lanes masked out (``aggregate_metrics_psum``).
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from mav_detection_tpu_torch.ops.image.metrics import tpr_fpr_counts
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    FrameOutputs,
    detect_frame_batch,
)

# gloo ranks the CPU offers: as many as the reference's test mesh has
# virtual CPU devices
CPU_DEVICES = 8
# seconds a launch waits for its ranks (and the group for a collective)
LAUNCH_TIMEOUT_S = 900.0

Device = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """This process's place in a process group: ``rank`` of ``size``, the
    global ranks of the group in order, and the device it computes on.
    ``group`` None is the default (world) group."""
    rank: int
    size: int
    device: torch.device
    ranks: Tuple[int, ...]
    group: Any = None

    def peer(self, index: int) -> int:
        """Global rank of the group's member ``index``."""
        return self.ranks[index]


def available_devices(device: Device) -> int:
    """Devices a mesh can span: the cards, or ``CPU_DEVICES`` gloo ranks."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return CPU_DEVICES


def backend_for(device: Device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(n_devices: Optional[int] = None, device: Device = "cuda") -> Mesh:
    """The mesh of the initialised default group on ``device``'s kind: rank
    ``r`` on ``cuda:<local rank>`` (``LOCAL_RANK`` where the launcher sets
    it) or on the CPU. ``n_devices`` must equal the group's size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group or launch)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"--devices {n_devices} but the process group has "
                         f"{size} ranks")
    kind = torch.device(device).type
    backend = dist.get_backend()
    if kind == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"a mesh on the card needs the nccl backend, "
                               f"the group runs {backend}")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh(rank=dist.get_rank(), size=size, device=dev,
                ranks=tuple(range(size)))


def sub_mesh(mesh: Mesh, members: Sequence[int], groups: Dict[Tuple[int, ...], Any]
             ) -> Mesh:
    """The mesh of the subgroup of ``mesh``'s members ``members`` (this rank
    among them) out of ``groups``, made by ``grid``."""
    members = tuple(members)
    return Mesh(rank=members.index(mesh.rank), size=len(members),
                device=mesh.device, ranks=tuple(mesh.peer(i) for i in members),
                group=groups[members])


def grid(mesh: Mesh, data: int, rows: int
         ) -> Tuple[Optional[Mesh], Optional[Mesh]]:
    """A 2-D (data x rows) layout of the mesh's first ``data * rows`` ranks
    (rank = d * rows + s): this rank's ``data`` mesh (the ranks with its row
    index) and ``rows`` mesh (the ranks with its data index), or (None,
    None) for a rank outside the layout. Every rank makes every subgroup,
    in one order, as ``new_group`` requires."""
    if data * rows > mesh.size:
        raise ValueError(f"a {data}x{rows} grid needs {data * rows} ranks, the "
                         f"mesh has {mesh.size}")
    layouts = ([tuple(d * rows + s for d in range(data)) for s in range(rows)]
               + [tuple(d * rows + s for s in range(rows)) for d in range(data)])
    groups = {r: dist.new_group([mesh.peer(i) for i in r]) for r in layouts}
    if mesh.rank >= data * rows:
        return None, None
    d, s = divmod(mesh.rank, rows)
    return (sub_mesh(mesh, [i * rows + s for i in range(data)], groups),
            sub_mesh(mesh, [d * rows + j for j in range(rows)], groups))


# ------------------------------------------------------------- collectives
def all_reduce_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place sum of ``t`` over the mesh."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the mesh in place with one all-reduce of
    their concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum_(flat, mesh).mul_(1.0 / mesh.size)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_gather_cat(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Rank ``src``'s ``tensors`` onto every rank, in place."""
    for t in tensors:
        dist.broadcast(t, mesh.peer(src), group=mesh.group)


# ------------------------------------------------------------ frame batches
def lanes(n: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(start, stop, per) of this rank's contiguous lanes of a batch of
    ``n`` padded to a multiple of the mesh size."""
    per = -(-n // mesh.size)
    return mesh.rank * per, (mesh.rank + 1) * per, per


def pad_to(arr, n: int):
    """``arr`` (tensor or array) padded along axis 0 to ``n`` by repeating
    its last element."""
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand((pad,) + tuple(arr.shape[1:]))])
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


def shard_frame_batch(mesh: Mesh, *arrays):
    """This rank's contiguous lanes of each batch-leading array, the batch
    padded to a multiple of the mesh size by repeating its last lane."""
    out = []
    for a in arrays:
        start, stop, per = lanes(a.shape[0], mesh)
        out.append(pad_to(a, per * mesh.size)[start:stop])
    return tuple(out)


def run_sharded(mesh: Mesh, fn: Callable, *arrays):
    """``fn(mesh, *lanes)`` on this rank's lanes of batch-leading arrays
    replicated on every rank (a launch's rank function)."""
    local = shard_frame_batch(mesh, *arrays)
    return fn(mesh, *(torch.as_tensor(a).to(mesh.device) for a in local))


def detect_frames_sharded(mesh: Mesh, flow, gt_flow, omega, dt, seg, sky,
                          depth, gt_foe, sample_yx,
                          config: DetectionStep = DetectionStep()) -> FrameOutputs:
    """The fused detection step on this rank's lanes of the batch (the
    padded ones included): ``FrameOutputs`` of those lanes. ``sample_yx``
    (n, 2N, 2) holds the whole batch's draws, so that lane ``i`` votes on
    the unsharded run's samples of lane ``i``."""
    args = shard_frame_batch(mesh, flow, gt_flow, omega, dt, seg, sky, depth,
                             gt_foe, sample_yx)
    args = tuple(a.to(mesh.device) for a in args)
    return detect_frame_batch(*args[:-1], sample_yx=args[-1], config=config)


def aggregate_metrics_psum(mesh: Mesh, segmentation: torch.Tensor,
                           estimate: torch.Tensor,
                           valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel TPR/FPR of the whole batch from this rank's lanes: each rank
    counts [tp, fp, pos, neg] (``tpr_fpr_counts``), one all-reduce sums
    them, and every rank returns TPR = tp/pos and FPR = fp/neg as 0-d
    tensors. ``valid`` (this rank's lanes) masks out frames padded to reach
    a multiple of the mesh size: an all-zero padded segmentation would
    otherwise count its whole area as negatives and bias FPR low."""
    if valid is None:
        valid = torch.ones((segmentation.shape[0],), dtype=torch.bool,
                           device=segmentation.device)
    total = all_reduce_sum_(tpr_fpr_counts(segmentation, estimate,
                                           valid.to(torch.float32)), mesh)
    return total[0] / total[2], total[1] / total[3]


# ---------------------------------------------------------------- launcher
def _to_host(obj):
    """``obj`` with every tensor moved to the CPU (tuples, named tuples,
    lists and dicts walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, kind: str, store: str, timeout_s: float,
               threads: int, job: bytes, all_ranks: bool, results) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, report."""
    try:
        fn, args = pickle.loads(job)
        if kind == "cpu":
            torch.set_num_threads(threads)
        else:
            torch.cuda.set_device(rank)
        dist.init_process_group(backend_for(kind), init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        out = fn(make_mesh(world, kind), *args)
        keep = all_ranks or rank == 0
        # by value: the queue's own pickler would share tensors through file
        # descriptors, which die with this process
        results.put(("ok", rank, pickle.dumps(_to_host(out) if keep else None)))
    except Exception:  # noqa: BLE001 - reported to the launcher
        results.put(("err", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n_devices: int, device: Device = "cuda", *args,
           timeout_s: float = LAUNCH_TIMEOUT_S, all_ranks: bool = False):
    """Run ``fn(mesh, *args)`` on ``n_devices`` spawned ranks (NCCL on the
    cards, gloo on the CPU) and return rank 0's result, or with
    ``all_ranks`` the list of every rank's. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function); they reach the ranks by value, and
    tensors come back on the CPU. A rank that raises, dies or outlasts
    ``timeout_s`` fails the call, and every rank is stopped before it
    returns. CPU ranks run with the caller's intra-op thread count."""
    import multiprocessing as mp

    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards, "
                           f"{torch.cuda.device_count()} are visible")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mesh-")
    results = ctx.Queue()
    # by value: a tensor handed to a spawned process would otherwise share
    # its storage with the caller's, and a rank's in-place update reach it
    job = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", args=(
        r, n_devices, kind, os.path.join(tmp, "store"), timeout_s,
        torch.get_num_threads(), job, all_ranks, results))
        for r in range(n_devices)]
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < n_devices:
            try:
                status, rank, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{dead[0].name} exited with code "
                                       f"{dead[0].exitcode} before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(n_devices)) - set(got))} "
                                       f"did not finish within {timeout_s:.0f} s")
                continue
            if status == "err":
                raise RuntimeError(f"rank {rank} of {n_devices} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if all_ranks:
        return [got[r] for r in range(n_devices)]
    return got[0]

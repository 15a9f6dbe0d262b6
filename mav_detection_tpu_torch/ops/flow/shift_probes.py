"""Probe kernels of the Farneback warp's shifted reads: their CUDA
wrappers, plain PyTorch versions and bounds.

Replace the reference's Pallas probe kernels, which take the fused
iteration's y stage apart (``tools/gather_probe.py::chain_kernel`` and
``::gather_kernel``, ``tools/chain_probe.py::kern`` variants A-D). Each is
one kernel of ``csrc/shift_probes.cu``:

* ``shift_chain``: out(r, c) = sum over s = -S .. S+1 of w_s x[r + S + s, c]
  (axis 0) or x[r, c + S + s] (axis 1), w_s = [sy = s](1 - fy) +
  [sy = s - 1] fy, the (2S+2)-step select chain of the TPU kernel;
* ``shift_gather``: the same two taps gathered, (1 - fy) x[i0] + fy x[i1];
* ``y_stage``: the fused kernel's y stage over 5 slab planes summed, as the
  chain (A), the chain with its mask carried (B), select-accumulated taps
  and one lerp (C), C in bf16 (D), and the two taps read directly (T, the
  port kernel's own form: ``csrc/farneback_iter.cu``'s y stage).

``shift_chain`` and ``y_stage`` stage their inputs in shared memory with
cp.async (each byte read from device memory once) and roll each thread's
taps through registers, so that the forms differ only in their arithmetic;
``shift_gather`` stays one thread per cell, its two taps through ``__ldg``.

Nothing on the main path calls them: the probe entry points
(``mav_detection_tpu_torch/tools/``) and ``chip_smoke.py`` do. Each plain
version does the kernel's IEEE float operations in the same order, so on
the card the two are equal (``torch.equal``). The geometry is the chain
probe's: P = S + 1 + m, slab rows th + 2P and columns tw + 2P, M-region
rows mrows = th + 2m, A-window columns acols = tw + 2m + 2S + 1, and the
shift-0 tap of output cell (j, a) at slab row o_f + j, column o_a + a with
o_f = P - m and o_a = P - m - S.

Wrappers dispatch on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from mav_detection_tpu_torch import _build

VARIANTS = ("A", "B", "C", "D", "T")
# each y_stage variant counted apart
KERNELS = _build.counted("shift_chain", "shift_gather",
                         *(f"y_stage_{v}" for v in VARIANTS))

# fp32 add, subtract and multiply per output cell of each kernel, counted
# from csrc/shift_probes.cu (compares, selects, conversions and index work
# not counted): the chain 1 - fy once, then per step the weight's add, a
# multiply and an add; the gather 1 - fy, two multiplies, an add; the y
# stage's A and B 1 - fy, then per step the weight's add and 5 planes x
# (multiply, add); C and D 5 lerps of 3; T 1 - fy and 5 x 3; all four sums
# of the planes
_OPS_PLANE_SUM = 4


class YGeometry(NamedTuple):
    """The chain probe's block geometry for max_shift S, band rows th,
    band columns tw and box half-width m."""
    S: int
    th: int
    tw: int
    m: int

    @property
    def P(self) -> int:
        return self.S + 1 + self.m

    @property
    def mrows(self) -> int:
        return self.th + 2 * self.m

    @property
    def acols(self) -> int:
        return self.tw + 2 * self.m + 2 * self.S + 1

    @property
    def sr(self) -> int:
        return self.th + 2 * self.P

    @property
    def cw(self) -> int:
        return self.tw + 2 * self.P

    @property
    def o_f(self) -> int:
        return self.P - self.m

    @property
    def o_a(self) -> int:
        return self.P - self.m - self.S


def shift_x_shape(rows: int, cols: int, S: int, axis: int):
    """x's (and sy's, fy's) padded shape for a (rows, cols) output."""
    return (rows + 2 * S + 1, cols) if axis == 0 else (rows, cols + 2 * S + 1)


def shift_out_shape(x_shape, S: int, axis: int):
    """The (rows, cols) output of a padded x."""
    nr, nc = x_shape
    return (nr - 2 * S - 1, nc) if axis == 0 else (nr, nc - 2 * S - 1)


# ------------------------------------------------------------ inputs
def shift_inputs(rng: np.random.Generator, rows: int, cols: int, S: int,
                 axis: int, device="cpu"):
    """x standard normal, sy integers in [-S, S] and fy in [0, 1), float32,
    at x's padded shape, drawn in that order as the gather probe draws
    them."""
    shape = shift_x_shape(rows, cols, S, axis)
    x = rng.standard_normal(shape)
    sy = rng.integers(-S, S + 1, shape)
    fy = rng.random(shape)
    return tuple(torch.as_tensor(a, dtype=torch.float32).to(device)
                 for a in (x, sy, fy))


def y_stage_inputs(rng: np.random.Generator, g: YGeometry, bands: int,
                   device="cpu"):
    """slab (bands, 5, sr, cw) standard normal, sy (bands, mrows, acols)
    integers in [-S, S], fy in [0, 1), float32, drawn in that order as the
    chain probe draws them."""
    slab = rng.standard_normal((bands, 5, g.sr, g.cw))
    sy = rng.integers(-g.S, g.S + 1, (bands, g.mrows, g.acols))
    fy = rng.random((bands, g.mrows, g.acols))
    return tuple(torch.as_tensor(a, dtype=torch.float32).to(device)
                 for a in (slab, sy, fy))


# ------------------------------------------------------------ plain versions
def shift_chain_ref(x: torch.Tensor, sy: torch.Tensor, fy: torch.Tensor,
                    S: int, axis: int) -> torch.Tensor:
    """Plain version of ``shift_chain``: the (2S+2) select steps added in s
    order to a zero accumulator."""
    rows, cols = shift_out_shape(x.shape, S, axis)
    sy = sy[:rows, :cols]
    fy = fy[:rows, :cols]
    acc = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    for s in range(-S, S + 2):
        wgt = torch.where(sy == s, 1.0 - fy, 0.0) + torch.where(sy == s - 1, fy, 0.0)
        k = S + s
        xs = x[k:k + rows, :] if axis == 0 else x[:, k:k + cols]
        acc = acc + wgt * xs
    return acc


def shift_gather_ref(x: torch.Tensor, sy: torch.Tensor, fy: torch.Tensor,
                     S: int, axis: int) -> torch.Tensor:
    """Plain version of ``shift_gather``: the two taps at clamped indices,
    sy and fy read at the output's cell of their padded arrays."""
    rows, cols = shift_out_shape(x.shape, S, axis)
    n = x.shape[axis]
    sy = sy[:rows, :cols]
    fy = fy[:rows, :cols]
    pos = torch.arange(rows if axis == 0 else cols, device=x.device)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    i0 = torch.clamp(pos + sy.to(torch.int64) + S, 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    g0 = torch.gather(x, axis, i0)
    g1 = torch.gather(x, axis, i1)
    return (1.0 - fy) * g0 + fy * g1


def y_stage_ref(slab: torch.Tensor, sy: torch.Tensor, fy: torch.Tensor,
                S: int, m: int, variant: str) -> torch.Tensor:
    """Plain version of ``y_stage``: (bands, 1, mrows, acols), the sum of the
    5 planes' y stage in the form ``variant`` (one of ``VARIANTS``)."""
    g = _y_geometry(slab.shape, sy.shape, S, m)
    mrows, acols = g.mrows, g.acols

    def tap(s):
        r = g.o_f + s
        return slab[:, :, r:r + mrows, g.o_a:g.o_a + acols]

    sy5 = sy[:, None]
    fy5 = fy[:, None]
    if variant in ("A", "B"):
        A = torch.zeros(slab.shape[:2] + (mrows, acols), dtype=slab.dtype,
                        device=slab.device)
        w0 = 1.0 - fy5
        m_prev = torch.zeros_like(sy5, dtype=torch.bool)
        for s in range(-S, S + 2):
            mk = sy5 == s
            m1 = sy5 == s - 1 if variant == "A" else m_prev
            wgt = torch.where(mk, w0, 0.0) + torch.where(m1, fy5, 0.0)
            A = A + wgt * tap(s)
            m_prev = mk
    elif variant in ("C", "D"):
        dt = torch.bfloat16 if variant == "D" else slab.dtype
        accf = torch.zeros(slab.shape[:2] + (mrows, acols), dtype=dt,
                           device=slab.device)
        accc = accf
        for s in range(-S, S + 1):
            mk = sy5 == s
            accf = torch.where(mk, tap(s).to(dt), accf)
            accc = torch.where(mk, tap(s + 1).to(dt), accc)
        lo = accf.float()
        A = lo + fy5 * (accc.float() - lo)
    elif variant == "T":
        k = torch.clamp(sy5, -S, S).to(torch.int64)
        rows = torch.arange(mrows, device=slab.device)[None, None, :, None]
        idx = (rows + g.o_f + k).expand(slab.shape[0], 5, mrows, acols)
        cols = slab[:, :, :, g.o_a:g.o_a + acols]
        A = ((1.0 - fy5) * torch.gather(cols, 2, idx)
             + fy5 * torch.gather(cols, 2, idx + 1))
    else:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    return (A[:, 0] + A[:, 1] + A[:, 2] + A[:, 3] + A[:, 4])[:, None]


def _y_geometry(slab_shape, sy_shape, S: int, m: int) -> YGeometry:
    bands, planes, sr, cw = slab_shape
    P = S + 1 + m
    g = YGeometry(S, sr - 2 * P, cw - 2 * P, m)
    want = (bands, g.mrows, g.acols)
    if planes != 5 or g.th < 1 or g.tw < 1 or tuple(sy_shape) != want:
        raise ValueError(f"y_stage: slab {tuple(slab_shape)} with sy "
                         f"{tuple(sy_shape)} at S={S}, m={m}: need (bands, 5, "
                         f"th + 2P, tw + 2P) and {want}")
    return g


# ------------------------------------------------------------ bounds
def shift_bytes(rows: int, cols: int, S: int, axis: int) -> int:
    """Bytes ``shift_chain`` / ``shift_gather`` must move: x read once at
    its padded shape, sy and fy once at the (rows, cols) output cells (the
    only cells the kernels read of them), the output written once."""
    nr, nc = shift_x_shape(rows, cols, S, axis)
    return 4 * (nr * nc + 3 * rows * cols)


def shift_ops(kernel: str, rows: int, cols: int, S: int) -> int:
    """fp32 operations of ``shift_chain`` / ``shift_gather`` on a
    (rows, cols) output."""
    per = 1 + 3 * (2 * S + 2) if kernel == "shift_chain" else 4
    return per * rows * cols


def y_stage_bytes(g: YGeometry, bands: int) -> int:
    """Bytes ``y_stage`` must move: the slab read once where it is read
    (rows o_f - S = 1 .. sr - 1, columns o_a = 1 .. cw - 1 of each plane;
    its row 0 and column 0 never), sy and fy read once, the output written
    once."""
    return 4 * bands * (5 * (g.sr - 1) * (g.cw - 1) + 3 * g.mrows * g.acols)


def y_stage_ops(g: YGeometry, bands: int, variant: str) -> int:
    """fp32 operations of ``y_stage`` in form ``variant``."""
    per = {"A": 1 + 11 * (2 * g.S + 2), "B": 1 + 11 * (2 * g.S + 2),
           "C": 15, "D": 15, "T": 16}[variant] + _OPS_PLANE_SUM
    return per * bands * g.mrows * g.acols


# ------------------------------------------------------------ CUDA wrappers
def _on_device(kernel: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    return True


def _shift(kernel: str, x, sy, fy, S: int, axis: int, out):
    if axis not in (0, 1) or S < 0:
        raise ValueError(f"{kernel}: axis={axis}, S={S}")
    rows, cols = shift_out_shape(x.shape, S, axis) if x.dim() == 2 else (0, 0)
    if rows < 1 or cols < 1:
        raise ValueError(f"{kernel}: x {tuple(x.shape)} has no output at "
                         f"S={S}, axis={axis}")
    for name, t in (("x", x), ("sy", sy), ("fy", fy)):
        _build.check_tensor(name, t, x.shape)
    if out is None:
        out = torch.empty((rows, cols), dtype=x.dtype, device=x.device)
    _build.check_tensor("out", out, (rows, cols))
    _build.launch("shift_probes", kernel, x.device, x.data_ptr(), sy.data_ptr(),
                  fy.data_ptr(), out.data_ptr(), rows, cols, axis, int(S))
    return out


def shift_chain(x: torch.Tensor, sy: torch.Tensor, fy: torch.Tensor, S: int,
                axis: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (2S+2)-step chain along ``axis`` of padded x (see
    ``shift_x_shape``); (rows, cols), into ``out`` where given."""
    if not _on_device("shift_chain", x):
        return shift_chain_ref(x, sy, fy, S, axis)
    return _shift("shift_chain", x, sy, fy, S, axis, out)


def shift_gather(x: torch.Tensor, sy: torch.Tensor, fy: torch.Tensor, S: int,
                 axis: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The two taps of ``shift_chain`` gathered; the same shapes."""
    if not _on_device("shift_gather", x):
        return shift_gather_ref(x, sy, fy, S, axis)
    return _shift("shift_gather", x, sy, fy, S, axis, out)


def y_stage(slab: torch.Tensor, sy: torch.Tensor, fy: torch.Tensor, S: int,
            m: int, variant: str,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 5-plane y stage in form ``variant``: slab (bands, 5, th + 2P,
    tw + 2P), sy and fy (bands, mrows, acols) -> (bands, 1, mrows, acols),
    into ``out`` where given."""
    kernel = f"y_stage_{variant}"
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if not _on_device(kernel, slab):
        return y_stage_ref(slab, sy, fy, S, m, variant)
    if slab.dim() != 4 or sy.dim() != 3 or S < 0 or m < 0:
        raise ValueError(f"{kernel}: slab {tuple(slab.shape)}, sy "
                         f"{tuple(sy.shape)}, S={S}, m={m}")
    g = _y_geometry(slab.shape, sy.shape, S, m)
    bands = slab.shape[0]
    _build.check_tensor("slab", slab, slab.shape)
    _build.check_tensor("sy", sy, (bands, g.mrows, g.acols))
    _build.check_tensor("fy", fy, (bands, g.mrows, g.acols))
    if out is None:
        out = torch.empty((bands, 1, g.mrows, g.acols), dtype=slab.dtype,
                          device=slab.device)
    _build.check_tensor("out", out, (bands, 1, g.mrows, g.acols))
    _build.launch("shift_probes", kernel, slab.device, slab.data_ptr(), sy.data_ptr(),
                  fy.data_ptr(), out.data_ptr(), bands, g.th, g.tw, m, int(S),
                  VARIANTS.index(variant), entry="y_stage")
    return out


def kernel_info(kernel: str, S: int, sub: int = 0,
                mrows: Optional[int] = None) -> Dict[str, int]:
    """Launch resources of one kernel instance on the current card
    (``kernel`` one of ``KERNELS``; ``sub`` the axis of the shift kernels;
    ``mrows`` the y stage's output rows a band, which set its block):
    threads a block, registers per thread, static and dynamic shared memory
    a block, resident blocks per SM."""
    rows = 0
    if kernel.startswith("y_stage_"):
        if mrows is None or mrows < 1:
            raise ValueError(f"{kernel}: kernel_info needs the output rows mrows")
        which, sub, rows = 2, VARIANTS.index(kernel[len("y_stage_"):]), int(mrows)
    else:
        which = ("shift_chain", "shift_gather").index(kernel)
    return _build.kernel_resources(
        "shift_probes", "shift_probe_info", which, sub, int(S), rows,
        keys=("registers", "smem_bytes", "blocks_per_sm", "threads", "dyn_smem_bytes"))

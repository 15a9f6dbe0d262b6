"""The port's frame-batch data parallel and time-chunked engines
(``mav_detection_tpu_torch.parallel.mesh``, ``pipeline/temporal.py::
detect_video_chunked``, the Processor's ``devices > 1`` branches) held to
the JAX package's on its virtual CPU mesh (``tests/conftest.py`` gives it 8
devices) and to the port's own single-device runs.

The port runs one process per device: every call here spawns 2 or 3 gloo
ranks through ``parallel.mesh.launch`` (a ``file://`` rendezvous in a fresh
temporary directory, a timeout on the group and on the wait), and the rank
functions are the port's own, so no rank imports JAX.

Tolerances: the sharded runs against the port's unsharded ones on the same
draws are exact (the same functions on the same lanes) and held to 1e-6;
against the JAX package, FoE 1e-3 px and rates 1e-5 (its reference's gate,
tests/test_parallel_pipeline.py), the chunked engine as the scan engine is
held in tests/test_torch_temporal.py.
"""
import functools
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.ops.flow import farneback as jf
from mav_detection_tpu.parallel import aggregate_metrics_psum as j_psum
from mav_detection_tpu.parallel import detect_frames_sharded as j_detect_sharded
from mav_detection_tpu.parallel import make_mesh as j_make_mesh
from mav_detection_tpu.pipeline import temporal as jt
from mav_detection_tpu.pipeline.detector import DetectionStep as JStep
from mav_detection_tpu.pipeline.processor import Processor as JProcessor

from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.data.dataset import imread
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.models import raft as traft
from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.parallel import mesh as pmesh
from mav_detection_tpu_torch.pipeline import detector as tdet
from mav_detection_tpu_torch.pipeline import temporal as tt
from mav_detection_tpu_torch.pipeline.processor import Processor

torch.set_num_threads(1)

# seconds a launch may take before its test fails (a spawn is ~5 s here)
TIMEOUT_S = 240.0
# On this sequence the port's one-device FoE loop equals the JAX package's
# on GT flow and the same draws. With expansion 0.05 and the FoE at (40, 30)
# the two one-device loops already disagree on pair 5: a line pair parallel
# up to rounding intersects under XLA's fused multiply-adds and not in IEEE
# arithmetic, and the vote ties one apart (ROADMAP C, divergences by
# design), which says nothing of the sharding held here.
SEQ = dict(height=72, width=96, expansion=0.03, foe=(45.0, 35.0), drone_radius=5,
           drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))
N_SAMPLES = 300
RATES = ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr")


@pytest.fixture(scope="module")
def rng():
    """This file's own generator (not the repository-wide fixture)."""
    return np.random.default_rng(2024)


def launch(fn, n, *args, **kw):
    return pmesh.launch(fn, n, "cpu", *args, timeout_s=TIMEOUT_S, **kw)


def jax_samples(keys, n_samples, h, w):
    """(n, 2N, 2) (y, x) indices JAX's get_foe_dense draws from ``keys``."""
    out = []
    for k in keys:
        ky, kx = jax.random.split(k)
        out.append(np.stack([
            np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
            np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
    return np.stack(out)


def jax_batch_samples(n_pairs, batch, n_samples, h, w):
    """The JAX processor's per-batch FoE draws (one split per batch, one key
    per frame)."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(0, n_pairs, batch):
        key, sub = jax.random.split(key)
        out.append(jax_samples(jax.random.split(sub, batch), n_samples, h, w))
    return out


def jax_scan_samples(T, n_samples, h, w):
    """(T-1, 2N, 2): the reference's scan (and chunked) draws,
    ``fold_in(key, t)`` per global transition."""
    key = jax.random.PRNGKey(0)
    out = []
    for t in range(1, T):
        ky, kx = jax.random.split(jax.random.fold_in(key, t))
        out.append(np.stack([
            np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
            np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
    return np.stack(out)


def batch_inputs(rng, n, h=40, w=56):
    """Detection inputs of ``n`` frames: a radial field with a mover."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([0.12 * np.stack([xs - 30.0, ys - 18.0], -1)
                     + rng.standard_normal((h, w, 2)).astype(np.float32) * 0.3
                     for _ in range(n)]).astype(np.float32)
    segs = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        disc = (xs - 10 - 3 * i) ** 2 + (ys - 12 - i) ** 2 <= 16
        flow[i][disc] = (3.0, -2.0)
        segs[i][disc] = 255
    sky = np.zeros((n, h, w), bool)
    sky[:, :8] = True
    depth = np.broadcast_to(np.where(np.arange(h)[:, None] < 9, 100.0, 20.0),
                            (n, h, w)).astype(np.float32).copy()
    return [flow, flow + 0.1, (rng.standard_normal((n, 3)) * 0.05).astype(np.float32),
            np.full((n,), 0.05, np.float32), segs, sky, depth,
            np.tile(np.float32([30.0, 18.0]), (n, 1))]


# ------------------------------------------------------------------ the mesh
class TestMesh:
    def test_launch_reports_a_failing_rank(self):
        """A rank that raises fails the launch with its traceback; every
        rank is stopped."""
        with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
            launch(pmesh.run_sharded, 2, pmesh.detect_frames_sharded,
                   torch.zeros(2, 4))

    def test_lanes_pad_to_a_multiple_of_the_mesh(self):
        """Contiguous lanes; the batch padded by repeating its last lane (the
        reference's processor.py:424-440)."""
        mesh = pmesh.Mesh(rank=2, size=3, device=torch.device("cpu"), ranks=(0, 1, 2))
        assert pmesh.lanes(7, mesh) == (6, 9, 3)
        (got,) = pmesh.shard_frame_batch(mesh, torch.arange(7))
        assert got.tolist() == [6, 6, 6]
        (got,) = pmesh.shard_frame_batch(mesh, np.arange(9))
        assert got.tolist() == [6, 7, 8]

    def test_available_devices(self):
        assert pmesh.available_devices("cpu") == pmesh.CPU_DEVICES == 8
        assert pmesh.backend_for("cpu") == "gloo"
        assert pmesh.backend_for("cuda") == "nccl"

    def test_make_mesh_needs_a_group(self):
        with pytest.raises(RuntimeError, match="initialised process group"):
            pmesh.make_mesh(2, "cpu")


def test_aggregate_metrics_psum_masks_padded_lanes(rng):
    """Five real frames padded to eight (all-zero segmentations in the
    padding): the all-reduced TPR/FPR equal the JAX psum on its 8-device
    mesh with the same mask, and the rates of the five frames alone; without
    the mask the padded lanes bias the rates (here, all detections, FPR
    high)."""
    n, h, w = 8, 24, 32
    seg = np.zeros((n, h, w), np.uint8)
    est = np.zeros((n, h, w), np.uint8)
    seg[:5] = (rng.random((5, h, w)) > 0.9) * 255
    est[:5] = (rng.random((5, h, w)) > 0.7) * 255
    est[5:] = 255
    valid = np.arange(n) < 5
    ref = j_psum(j_make_mesh(8), jnp.asarray(seg), jnp.asarray(est), jnp.asarray(valid))
    got = launch(pmesh.run_sharded, 2, pmesh.aggregate_metrics_psum,
                 torch.from_numpy(seg), torch.from_numpy(est), torch.from_numpy(valid))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in ref],
                               rtol=1e-6)
    pos, neg = seg[:5] > 127, seg[:5] <= 127
    on = est[:5] > 127
    np.testing.assert_allclose(float(got[1]), (on & neg).sum() / neg.sum(), rtol=1e-6)
    unmasked = launch(pmesh.run_sharded, 2, pmesh.aggregate_metrics_psum,
                      torch.from_numpy(seg), torch.from_numpy(est))
    assert float(unmasked[1]) > float(got[1])
    assert float(got[0]) == pytest.approx((on & pos).sum() / pos.sum(), rel=1e-6)


def test_detect_frames_sharded(rng):
    """Each of 3 ranks runs the detection step on its lanes of a 7-frame
    batch (padded to 9): the lanes' outputs equal the unsharded step's on
    the same draws, and JAX's ``detect_frames_sharded`` on its 8-device
    mesh (8 frames) on the draws of its keys."""
    n = 8
    args = batch_inputs(rng, n)
    h, w = args[0].shape[1:3]
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    syx = jax_samples(keys, N_SAMPLES, h, w)
    step = tdet.DetectionStep(foe_samples=N_SAMPLES)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    parts = launch(pmesh.detect_frames_sharded, 3, *(a[:7] for a in targs),
                   torch.from_numpy(syx[:7]), step, all_ranks=True)
    sharded = tdet.FrameOutputs(*(torch.cat([getattr(p, f) for p in parts])[:7]
                                  for f in tdet.FrameOutputs._fields))
    plain = tdet.detect_frame_batch(*(a[:7] for a in targs),
                                    sample_yx=torch.from_numpy(syx[:7]), config=step)
    for f in tdet.FrameOutputs._fields:
        np.testing.assert_allclose(getattr(sharded, f).numpy().astype(np.float64),
                                   getattr(plain, f).numpy().astype(np.float64),
                                   atol=1e-6, equal_nan=True, err_msg=f)
    ref = j_detect_sharded(j_make_mesh(8), *(jnp.asarray(a) for a in args), keys,
                           config=JStep(foe_samples=N_SAMPLES))
    np.testing.assert_allclose(sharded.foe.numpy(), np.asarray(ref.foe)[:7], atol=1e-3)
    for f in RATES:
        np.testing.assert_allclose(getattr(sharded, f).numpy(),
                                   np.asarray(getattr(ref, f))[:7], atol=1e-5,
                                   equal_nan=True, err_msg=f)


def test_sharded_saturation_decides_as_the_whole_batch(rng):
    """The RAFT coverage check on a sharded batch: one decision for the
    whole batch, equal to ``flow_magnitude_quantile``'s on the batch at
    thresholds below, between and above the order statistics it
    interpolates."""
    flow = torch.from_numpy(rng.normal(size=(6, 16, 20, 2)).astype(np.float32) * 5)
    mag = np.sort(np.linalg.norm(flow.numpy(), axis=-1).ravel())
    q = traft.flow_magnitude_quantile(flow, 0.99)
    pos = 0.99 * (mag.size - 1)
    lo = mag[int(np.floor(pos))]
    for thr in (lo * 0.5, lo, np.nextafter(np.float32(q), np.float32(0)), q,
                (q + mag[-1]) / 2, mag[-1] * 2):
        fn = functools.partial(traft.quantile_reaches_sharded, threshold=float(thr))
        got, q_got = launch(pmesh.run_sharded, 2, fn, flow)
        assert got == (q >= float(thr)), thr
        if q_got is not None:
            assert q_got == pytest.approx(q, rel=1e-6)


# ------------------------------------------------------- the Processor (batch)
def _jax_processor(devices, n_frames, batch, flow_source="GROUND_TRUTH"):
    cfg = JRunConfig(logger=logging.getLogger("test"), dataset="synthetic",
                     mode="FLOW_FOE_CLUSTERING", flow_source=flow_source,
                     batch_size=batch, devices=devices, headless=True)
    proc = JProcessor(cfg)
    proc.dataset = JSynth(params=JParams(n_frames=n_frames, **SEQ))
    proc.save_images = False
    return proc


def port_processor(devices, n_frames, batch, flow_source="GROUND_TRUTH", **kw):
    cfg = RunConfig(logger=logging.getLogger("test"), dataset="synthetic",
                    mode="FLOW_FOE_CLUSTERING", flow_source=flow_source,
                    batch_size=batch, devices=devices, headless=True, **kw)
    cfg.get_dataset = lambda **_: SyntheticDataset(
        params=SyntheticParams(n_frames=n_frames, **SEQ))
    proc = Processor(cfg, device="cpu")
    proc.save_images = False
    return proc


def _assert_results(got, ref, foe_tol=1e-6, rate_tol=1e-6):
    assert sorted(got) == sorted(ref)
    for i in ref:
        a, b = ref[i].to_dict(), got[i].to_dict()
        for k in a:
            tol = foe_tol if k == "foe_dense" else rate_tol
            np.testing.assert_allclose(np.asarray(b[k], np.float64),
                                       np.asarray(a[k], np.float64), atol=tol,
                                       equal_nan=True, err_msg=f"frame {i} {k}")


@pytest.fixture(scope="module")
def sharded_runs():
    """9 frames (8 pairs), batch 8, fed GT flow, JAX's draws: the port on 2
    ranks and on one device, and the JAX package on its 8-device mesh."""
    h, w = SEQ["height"], SEQ["width"]
    syx = jax_batch_samples(8, 8, 1000, h, w)
    jproc = _jax_processor(8, 9, 8)
    ref = jproc.run_detection_foe()
    one = port_processor(0, 9, 8).run_detection_foe(sample_yx=syx)
    proc = port_processor(2, 9, 8)
    two = proc.run_detection_foe(sample_yx=syx)
    return dict(ref=ref, jproc=jproc, one=one, two=two, proc=proc)


class TestShardedProcessor:
    def test_sharded_matches_unsharded(self, sharded_runs):
        r = sharded_runs
        assert r["proc"]._ranks == 2 and r["proc"].mesh is None
        _assert_results(r["two"], r["one"])

    def test_sharded_matches_jax_mesh(self, sharded_runs):
        assert sharded_runs["jproc"].mesh is not None
        _assert_results(sharded_runs["two"], sharded_runs["ref"], foe_tol=1e-3,
                        rate_tol=1e-5)

    def test_psum_metrics_match_jax(self, sharded_runs):
        got = sharded_runs["proc"]._psum_metrics
        ref = sharded_runs["jproc"]._psum_metrics
        assert len(got) == len(ref) == 1 and got[0][2] == ref[0][2] == 8
        np.testing.assert_allclose(got[0][:2], ref[0][:2], rtol=1e-5)

    def test_results_reach_the_config(self, sharded_runs):
        proc = sharded_runs["proc"]
        assert proc.config.results == proc.detection_results == sharded_runs["two"]


def test_batch_padding_to_the_mesh(caplog):
    """5 pairs in batches of 3 on 2 ranks: each batch padded to 4 lanes; the
    tail's second rank holds padding only. Every pair is reported once, equal
    to the one-device run on the same seeded draws; the padded lanes stay
    out of the all-reduced rates; the log line carries them."""
    one = port_processor(0, 6, 3, flow_source="FARNEBACK").run_detection_foe()
    proc = port_processor(2, 6, 3, flow_source="FARNEBACK")
    assert proc.batch_size == 3
    with caplog.at_level(logging.INFO, logger="test"):
        two = proc.run_detection_foe()
    _assert_results(two, one)
    assert [m[2] for m in proc._psum_metrics] == [3, 2]
    assert "on-mesh psum metrics (2 devices): fixed-threshold TPR" in caplog.text
    assert port_processor(2, 6, 1).batch_size == 2


def test_sharded_loop_writes_the_one_device_artifacts(tmp_path):
    """With debug images on, 5 pairs in batches of 3 on 2 ranks (the tail's
    second rank holds padding only): each rank writes its real lanes' four
    PNGs, rank 0 the JSON and, once every rank is done, ``video.npz``. The
    files equal the one-device run's over its own copy of the sequence."""
    def run(devices, where):
        cfg = RunConfig(logger=logging.getLogger("test"), dataset="synthetic",
                        mode="FLOW_FOE_CLUSTERING", flow_source="GROUND_TRUTH",
                        batch_size=3, devices=devices, headless=True)
        cfg.get_dataset = lambda **_: SyntheticDataset(
            params=SyntheticParams(n_frames=6, **SEQ), materialize_to=str(where))
        proc = Processor(cfg, device="cpu")
        assert proc.save_images
        proc.run_detection_foe()
        return proc.dataset.seq_path

    one, two = run(0, tmp_path / "one"), run(2, tmp_path / "two")
    names = [f"image_{i:05d}" for i in range(5)]
    for kind in ("result-images", "derotated", "phi", "processed"):
        assert sorted(os.listdir(os.path.join(two, kind))) == [n + ".png" for n in names]
        for n in names:
            np.testing.assert_array_equal(imread(os.path.join(two, kind, n + ".png")),
                                          imread(os.path.join(one, kind, n + ".png")))
    for n in names:
        with open(os.path.join(two, "results", n + ".json")) as f, \
                open(os.path.join(one, "results", n + ".json")) as g:
            assert f.read() == g.read()
    np.testing.assert_array_equal(np.load(os.path.join(two, "video.npz"))["frames"],
                                  np.load(os.path.join(one, "video.npz"))["frames"])


@pytest.mark.parametrize("kw,match", [
    (dict(engine="spatial"), "requires --devices > 1"),
    (dict(engine="spatial", devices=2, flow_source="RAFT"), "spatial shards the Farneback"),
])
def test_engine_errors_keep_the_reference_words(kw, match):
    devices = kw.pop("devices", 0)
    with pytest.raises(ValueError, match=match):
        port_processor(devices, 4, 2, **kw)


def test_too_many_devices_run_unsharded(caplog):
    with caplog.at_level(logging.WARNING, logger="test"):
        proc = port_processor(9, 4, 2)
    assert proc._ranks == 0 and proc.mesh is None and proc.batch_size == 2
    assert "--devices 9 requested but only 8 available; running unsharded" in caplog.text


# ---------------------------------------------------------------- chunked
CHUNK_SEQ = dict(height=72, width=96, expansion=0.02, foe=(45.0, 35.0))
CHUNK_PARAMS = tf.FarnebackParams(warp="separable", fast=True, max_shift=8)


@pytest.fixture(scope="module")
def chunk_seq():
    proc = port_processor(0, 7, 2, engine="scan")
    proc.dataset = SyntheticDataset(params=SyntheticParams(n_frames=7, **CHUNK_SEQ))
    inp = proc._sequence_inputs()
    return [inp[k] for k in ("frames", "omegas", "dts", "segs", "skys", "depths",
                             "gt_foes")]


def test_chunked_matches_scan_and_jax(chunk_seq):
    """6 frames on 3 ranks (2 per chunk, two boundaries crossed by the
    one-frame halo): the chunked scalars equal the scan engine's on the same
    draws, and the JAX package's chunked engine on a 3-device mesh."""
    seq = [a[:6] for a in chunk_seq]
    h, w = seq[0].shape[1:3]
    draws = jax_scan_samples(6, 256, h, w)
    step = tdet.DetectionStep(foe_samples=256)
    got = launch(tt.detect_video_chunked, 3, *(torch.from_numpy(a) for a in seq),
                 torch.from_numpy(draws), CHUNK_PARAMS, step)
    scan, _ = tt.detect_sequence_scan(*(torch.from_numpy(a) for a in seq),
                                      sample_yx=torch.from_numpy(draws),
                                      params=CHUNK_PARAMS, config=step)
    for f in tdet.FrameScalars._fields:
        np.testing.assert_allclose(getattr(got, f).numpy().astype(np.float64),
                                   getattr(scan, f).numpy().astype(np.float64),
                                   atol=1e-6, equal_nan=True, err_msg=f)
    ref = jt.detect_video_chunked(
        j_make_mesh(3), *(jnp.asarray(a) for a in seq), jax.random.PRNGKey(0),
        params=jf.FarnebackParams(warp="separable", fast=True, max_shift=8),
        config=JStep(foe_samples=256))
    np.testing.assert_allclose(got.foe.numpy(), np.asarray(ref.foe), atol=0.05)
    for f in RATES:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=0.02, equal_nan=True, err_msg=f)


def test_chunked_engine_pads_and_matches_scan():
    """--engine chunked on 2 ranks over 7 frames (padded to 8 by repeating
    the last): one FrameResult per transition, equal to the scan engine's
    without explicit draws (every rank draws the scan engine's); with
    --use-sparse-of set it runs dense only, as the reference's does."""
    scan = port_processor(0, 7, 2, engine="scan").run_detection_foe()
    proc = port_processor(2, 7, 2, engine="chunked", use_sparse_of=True)
    chunked = proc.run_detection_foe()
    assert sorted(chunked) == list(range(6))
    _assert_results(chunked, scan)


def test_chunked_errors_without_a_mesh():
    """The reference's ValueErrors: chunked without a mesh, and a sequence
    length the mesh does not divide."""
    with pytest.raises(ValueError, match="chunked requires --devices > 1"):
        port_processor(0, 4, 2, engine="chunked").run_detection()
    mesh = pmesh.Mesh(rank=0, size=3, device=torch.device("cpu"), ranks=(0, 1, 2))
    frames = torch.zeros((10, 8, 8))
    with pytest.raises(ValueError, match="sequence length 10 not divisible by 3 devices"):
        tt.detect_video_chunked(mesh, frames, *([frames] * 6))

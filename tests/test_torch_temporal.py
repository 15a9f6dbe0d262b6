"""The port's temporal scan engine held to the JAX package's on the CPU:
``detect_sequence_scan`` as a function, and ``Processor`` with
``engine="scan"``.

The reference draws its FoE samples from per-transition keys,
``fold_in(key, t)`` for the global transition index t = 1..T-1, then
``split`` and two ``randint``s inside ``get_foe_dense``; the tests rebuild
those draws and hand them to the port as ``sample_yx``. Inputs are the
frame-indexed arrays that the port's ``Processor._sequence_inputs`` builds
from a seeded synthetic sequence, fed to both packages.

Tolerances, with their reasons:
* XLA-path flow (``separable``, ``fast``) inside the scan: history buffer
  within 1e-3 px of the reference's (its batch-1 level loop runs unfused
  preprocessing), rates within 0.02 (a pixel on a threshold may flip), FoE
  within 0.5 px (a sample whose flow differs at 1e-4 px moves its line
  intersection; measured far tighter on these sequences, and held to 0.05
  px where that holds), the ring's write index equal.
* fused path against the reference's Pallas kernel in interpret mode: the
  same.
* scan engine against the port's own batch engine with the same draws:
  1e-4 on every field but ``drone_flow_pixels`` (the same functions on the
  same frames; batch 1 against batch 2 differ by the matmuls' sum order),
  and ``drone_flow_pixels`` apart: the scan engine hands the detection step
  a zero ground-truth flow, as the reference's does.
* the sparse carry must not change the dense outputs: 1e-4, as
  tests/test_temporal.py asks of the reference.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.ops.flow import farneback as jf
from mav_detection_tpu.pipeline import temporal as jt
from mav_detection_tpu.pipeline.detector import DetectionStep as JStep
from mav_detection_tpu.pipeline.processor import Processor as JProcessor

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.cli.main import main as cli_main
from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.geometry import boxsearch as tbs
from mav_detection_tpu_torch.pipeline import temporal as tt
from mav_detection_tpu_torch.pipeline.detector import DetectionStep
from mav_detection_tpu_torch.pipeline.processor import Processor

# Tiny shapes: one intra-op thread, so that test workers running side by side
# do not oversubscribe the cores (thousands of small ops, each a thread barrier).
torch.set_num_threads(1)

# tests/test_temporal.py's configuration
J_PARAMS = jf.FarnebackParams(warp="separable", fast=True, max_shift=8)
T_PARAMS = tf.FarnebackParams(warp="separable", fast=True, max_shift=8)
N_SAMPLES = 256
MID = dict(height=96, width=128, expansion=0.02, foe=(70.0, 45.0))
SMALL = dict(height=48, width=64, n_frames=5, expansion=0.08, foe=(30.0, 20.0),
             drone_radius=5, drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))
RATES = ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr")


def jax_scan_samples(T, n_samples, h, w, key=None):
    """(T-1, 2N, 2) (y, x) indices the reference's scan draws."""
    key = jax.random.PRNGKey(0) if key is None else key
    out = []
    for t in range(1, T):
        ky, kx = jax.random.split(jax.random.fold_in(key, t))
        out.append(np.stack([
            np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
            np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
    return np.stack(out)


def port_processor(params, engine="scan", **cfg_kw):
    cfg_kw.setdefault("flow_source", "FARNEBACK")
    cfg = RunConfig(dataset="synthetic", engine=engine, batch_size=2, **cfg_kw)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(**params))
    return Processor(cfg, device="cpu")


def sequence(params):
    """The scan engine's frame-indexed numpy inputs, in the order both
    ``detect_sequence_scan``s take them."""
    inp = port_processor(params)._sequence_inputs()
    return [inp[k] for k in ("frames", "omegas", "dts", "segs", "skys", "depths",
                             "gt_foes")]


def run_jax(seq, params, n_samples, **kw):
    return jt.detect_sequence_scan(
        *(jnp.asarray(a) for a in seq), jax.random.PRNGKey(0), params=params,
        config=JStep(foe_samples=n_samples), **kw)


def run_port(seq, params, n_samples, sample_yx, **kw):
    return tt.detect_sequence_scan(
        *(torch.from_numpy(a) for a in seq), sample_yx=torch.from_numpy(sample_yx),
        params=params, config=DetectionStep(foe_samples=n_samples), **kw)


def assert_scalars_close(got, ref, foe_tol):
    g = {k: v.numpy() for k, v in got._asdict().items()}
    r = {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert set(g) == set(r)
    for k in r:
        assert g[k].shape == r[k].shape, k
        tol = 0.02 if k in RATES else foe_tol if k == "foe" else 1e-3
        np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True, err_msg=k)


@pytest.fixture(scope="module")
def mid_seq():
    return sequence(dict(MID, n_frames=6))


@pytest.fixture(scope="module")
def mid_draws():
    return jax_scan_samples(6, N_SAMPLES, MID["height"], MID["width"])


@pytest.fixture(scope="module")
def mid_dense(mid_seq, mid_draws):
    return run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws)


class TestSequenceScan:
    def test_dense_matches_jax(self, mid_seq, mid_draws, mid_dense):
        ref, ref_hist = run_jax(mid_seq, J_PARAMS, N_SAMPLES, history_len=4)
        got, hist = mid_dense
        T = mid_seq[0].shape[0]
        assert got.foe.shape == (T - 1, 2)
        assert_scalars_close(got, ref, foe_tol=0.05)
        assert hist.buffer.shape == (4, MID["height"], MID["width"], 2)
        np.testing.assert_allclose(hist.buffer.numpy(), np.asarray(ref_hist.buffer),
                                   atol=1e-3)
        assert hist.index == int(ref_hist.index) == (T - 1) % 4
        assert float(hist.buffer.abs().max()) > 0.1
        # the FoE lands near the scene's on the expanding sequence
        err = np.linalg.norm(got.foe.numpy() - np.array(MID["foe"]), axis=-1)
        assert np.median(err) < 25.0

    def test_history_is_the_pushed_flows(self, mid_seq, mid_dense):
        """The ring written in place equals ``push_flow`` of every
        transition's flow, oldest slot overwritten first."""
        frames = torch.from_numpy(mid_seq[0]).to(torch.float32)
        hist = tbs.make_flow_history(4, MID["height"], MID["width"])
        for t in range(1, frames.shape[0]):
            hist = tbs.push_flow(hist, tt._flow_pair(frames[t - 1], frames[t], T_PARAMS))
        assert torch.equal(mid_dense[1].buffer, hist.buffer)
        assert mid_dense[1].index == hist.index

    def test_sparse_carry_leaves_dense_outputs(self, mid_seq, mid_draws, mid_dense):
        """track_sparse on 6 frames with 128 tracks: a finite sparse FoE per
        transition, and the dense outputs unchanged by the extra carry."""
        got, hist, foe_sparse = run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws,
                                         track_sparse=True, n_tracks=128)
        assert foe_sparse.shape == (5, 2) and bool(torch.isfinite(foe_sparse).all())
        for a, b in zip(got, mid_dense[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, equal_nan=True)
        assert torch.equal(hist.buffer, mid_dense[1].buffer)

    def test_sparse_draws_are_explicit_or_seeded(self, mid_seq, mid_draws):
        """The same ``sparse_perm`` gives the same sparse FoE; without one
        the seeded generator repeats itself."""
        rng = np.random.default_rng(5)
        perm = torch.from_numpy(np.stack([rng.permutation(64) for _ in range(5)]))
        kw = dict(track_sparse=True, n_tracks=64)
        a = run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws, sparse_perm=perm, **kw)[2]
        b = run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws, sparse_perm=perm, **kw)[2]
        c = run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws, **kw)[2]
        d = run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws, **kw)[2]
        assert torch.equal(a, b) and torch.equal(c, d)
        with pytest.raises(ValueError, match="sparse_perm"):
            run_port(mid_seq, T_PARAMS, N_SAMPLES, mid_draws, sparse_perm=perm[:3], **kw)

    def test_seeded_generator_when_no_draws_are_given(self, mid_seq):
        args = [torch.from_numpy(a) for a in mid_seq]
        cfg = DetectionStep(foe_samples=64)
        a = tt.detect_sequence_scan(*args, params=T_PARAMS, config=cfg)[0]
        b = tt.detect_sequence_scan(*args, params=T_PARAMS, config=cfg)[0]
        assert torch.equal(a.foe, b.foe) and bool(torch.isfinite(a.foe).all())
        with pytest.raises(ValueError, match="sample_yx"):
            tt.detect_sequence_scan(*args, params=T_PARAMS, config=cfg,
                                    sample_yx=torch.zeros((5, 100, 2), dtype=torch.long))

    def test_frames_keep_their_dtype_until_their_step(self, mid_seq, mid_draws, mid_dense):
        """uint8 frames in, one frame converted per step: the same result as
        float32 frames (the synthetic frames are whole numbers)."""
        seq = [mid_seq[0].astype(np.float32)] + mid_seq[1:]
        assert mid_seq[0].dtype == np.uint8
        got, _ = run_port(seq, T_PARAMS, N_SAMPLES, mid_draws)
        assert torch.equal(got.foe, mid_dense[0].foe)

    def test_a_single_frame_has_no_transition(self, mid_seq):
        out, hist = tt.detect_sequence_scan(
            *(torch.from_numpy(a[:1]) for a in mid_seq), params=T_PARAMS,
            config=DetectionStep(foe_samples=16))
        assert out.foe.shape == (0, 2) and out.tpr.shape == (0,) and hist.index == 0


class _Looks:
    """Counts the ways a host can look at a tensor: ``item``, ``cpu``,
    ``tolist``, ``numpy``, a truth value, ``nonzero``."""

    NAMES = ("item", "cpu", "tolist", "numpy", "__bool__", "nonzero")

    def __init__(self, monkeypatch):
        self.seen = []
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(
                torch.Tensor, name,
                lambda t, *a, _n=name, _r=real, **k: self.seen.append(_n) or _r(t, *a, **k))


class TestHostLooks:
    def test_dense_loop_makes_no_host_look(self, mid_seq, mid_draws, monkeypatch):
        args = [torch.from_numpy(a) for a in mid_seq]
        draws = torch.from_numpy(mid_draws)
        cfg = DetectionStep(foe_samples=N_SAMPLES)
        for params in (T_PARAMS, tf.tuned_flow_params(MID["height"], MID["width"]),
                       tf.FarnebackParams(warp="auto", fast=True, levels=2, pyr_scale=0.5)):
            looks = _Looks(monkeypatch)
            tt.detect_sequence_scan(*args, sample_yx=draws, params=params, config=cfg)
            assert looks.seen == [], params.warp
            monkeypatch.undo()

    def test_counter_sees_a_look(self, monkeypatch):
        looks = _Looks(monkeypatch)
        t = torch.ones(3)
        bool(t.sum() > 0), t.sum().item(), t.cpu(), t.nonzero()
        assert looks.seen == ["__bool__", "item", "cpu", "nonzero"]

    def test_sparse_looks_come_from_the_corner_sweep_only(self, mid_seq, mid_draws,
                                                          monkeypatch):
        """With track_sparse every look is a truth value taken by the corner
        sweep (one per SWEEP_ROUNDS rounds): a few per replenishment, one
        replenishment per transition plus the initial pool's."""
        args = [torch.from_numpy(a) for a in mid_seq]
        looks = _Looks(monkeypatch)
        tt.detect_sequence_scan(*args, sample_yx=torch.from_numpy(mid_draws),
                                params=T_PARAMS, config=DetectionStep(foe_samples=N_SAMPLES),
                                track_sparse=True, n_tracks=128)
        n_replenish = mid_seq[0].shape[0]
        assert set(looks.seen) == {"__bool__"}
        assert n_replenish <= len(looks.seen) <= 4 * n_replenish


# ------------------------------------------------------ fused path, Processor
def _jax_scan_processor(farneback):
    cfg = JRunConfig(logger=logging.getLogger("t"), dataset="synthetic",
                     flow_source="FARNEBACK", engine="scan", headless=True)
    cfg.get_dataset = lambda **_: JSynth(params=JParams(**SMALL))
    proc = JProcessor(cfg)
    proc._farneback = farneback
    return proc


def _vals(fr):
    return {k: np.asarray(v, np.float64) for k, v in fr.to_dict().items()}


@pytest.fixture(scope="module")
def small_draws():
    return jax_scan_samples(SMALL["n_frames"], 1000, SMALL["height"], SMALL["width"])


@pytest.fixture(scope="module")
def port_scan_results(small_draws):
    return port_processor(SMALL).run_detection_foe(sample_yx=small_draws)


def test_fused_scan_matches_the_pallas_kernel_in_interpret_mode(small_draws):
    """The tuned (fused) flow inside the scan, 48x64, T = 5, against the
    reference's scan over its Pallas kernel in interpret mode."""
    seq = sequence(SMALL)
    j_tuned = jf.tuned_flow_params(SMALL["height"], SMALL["width"])
    t_tuned = convert.farneback_params_from_reference(
        {k: getattr(j_tuned, k) for k in j_tuned.__dataclass_fields__})
    assert t_tuned == tf.tuned_flow_params(SMALL["height"], SMALL["width"])
    ref, ref_hist = run_jax(seq, j_tuned, 1000)
    got, hist = run_port(seq, t_tuned, 1000, small_draws)
    assert_scalars_close(got, ref, foe_tol=0.5)
    np.testing.assert_allclose(hist.buffer.numpy(), np.asarray(ref_hist.buffer), atol=1e-3)
    assert hist.index == int(ref_hist.index)


def test_scan_engine_json_matches_jax(port_scan_results):
    """``Processor(engine="scan")`` against the reference's
    ``run_detection_foe_scan`` with the JAX side set to the tuned
    parameters: one FrameResult per transition, same schema."""
    ref = _jax_scan_processor(
        jf.tuned_flow_params(SMALL["height"], SMALL["width"])).run_detection()
    got = port_scan_results
    assert sorted(got) == sorted(ref) == list(range(SMALL["n_frames"] - 1))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        assert set(r) == set(g)
        for k in r:
            tol = 0.5 if k == "foe_dense" else 0.02 if k in RATES else 1e-3
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_scan_engine_matches_the_batch_engine(port_scan_results, small_draws):
    """The same sequence through the port's batch engine with the same
    per-transition draws: every field within 1e-4, except
    ``drone_flow_pixels`` (the scan derotates a zero ground-truth flow, the
    batch engine the dataset's)."""
    n = SMALL["n_frames"] - 1
    padded = np.concatenate([small_draws, small_draws[-1:]])
    got = port_processor(SMALL, engine="batch").run_detection_foe(
        sample_yx=[padded[k:k + 2] for k in range(0, n, 2)])
    for i in range(n):
        s, b = _vals(port_scan_results[i]), _vals(got[i])
        for k in s:
            if k == "drone_flow_pixels":
                continue      # minus the rotational field's mean on the target
            np.testing.assert_allclose(s[k], b[k], atol=1e-4, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_scan_engine_writes_json_and_pulls_once(tmp_path, monkeypatch):
    """One upload, one pull of the packed (T-1, 12) scalars, one JSON file
    per transition, no debug images."""
    proc = port_processor(SMALL)
    proc.dataset.seq_path = str(tmp_path)
    proc.dataset.results_path = str(tmp_path / "results")
    pulls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: pulls.append(tuple(self.shape))
                        or real(self, *a, **k))
    res = proc.run_detection()
    n = SMALL["n_frames"] - 1
    assert pulls == [(n, 12)]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["results"]
    for i, fr in res.items():
        assert (tmp_path / "results" / f"image_{i:05d}.json").read_text() == fr.to_json()
    assert proc.tracer.counts["scan"] == 1


def test_scan_engine_sparse_sidecar(tmp_path, caplog):
    proc = port_processor(SMALL, use_sparse_of=True)
    proc.dataset.seq_path = str(tmp_path)
    proc.dataset.results_path = str(tmp_path / "results")
    with caplog.at_level(logging.INFO, logger=proc.logger.name):
        res = proc.run_detection()
    n = SMALL["n_frames"] - 1
    sidecar = np.load(tmp_path / "results" / "foe_sparse.npy")
    assert sidecar.shape == (n, 2) and np.isfinite(sidecar).all()
    assert len(res) == n and "sparse FoE (LK traces): median" in caplog.text


@pytest.mark.parametrize("flow_source,raises", [
    ("RAFT", True), ("LUCAS_KANADE", True), ("PRECOMPUTED", False),
    ("GROUND_TRUTH", False)])
def test_scan_engine_flow_sources(flow_source, raises, caplog):
    """RAFT and LUCAS_KANADE cannot ride the scan; any other source is
    ignored with a warning and Farneback flow is computed."""
    proc = port_processor(dict(SMALL, n_frames=3), flow_source=flow_source)
    if raises:
        with pytest.raises(ValueError, match="not supported there"):
            proc.run_detection()
        return
    with caplog.at_level(logging.WARNING, logger=proc.logger.name):
        res = proc.run_detection()
    assert len(res) == 2 and f"flow-source {flow_source} ignored" in caplog.text


def test_chunked_without_devices_raises():
    proc = port_processor(SMALL, engine="chunked")
    with pytest.raises(ValueError, match="chunked requires --devices > 1"):
        proc.run_detection()


@pytest.mark.parametrize("kw", [dict(engine="chunked", devices=2), dict(engine="scan", devices=2),
                                dict(engine="spatial")])
def test_multi_device_engines_are_not_ported(kw):
    """The multi-device engines are ported (tests/test_torch_parallel*.py):
    chunked constructs with its ranks to spawn; scan with devices runs
    unsharded in the caller, as the reference's does; spatial without
    devices raises the reference's ValueError."""
    if kw["engine"] == "spatial":
        with pytest.raises(ValueError, match="requires --devices > 1"):
            port_processor(SMALL, **kw)
        return
    proc = port_processor(SMALL, **kw)
    assert proc._ranks == 2
    if kw["engine"] == "scan":
        res = proc.run_detection()
        assert sorted(res) == list(range(SMALL["n_frames"] - 1))


def test_scan_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    cfg = RunConfig(dataset="synthetic", flow_source="FARNEBACK", engine="scan")
    with pytest.raises(RuntimeError, match="cuda"):
        Processor(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["--dataset", "synthetic", "--flow-source", "FARNEBACK",
                  "--engine", "scan", "--headless"])


@pytest.mark.parametrize("extra", [[], ["--use-sparse-of"]], ids=["dense", "sparse"])
def test_cli_engine_scan_on_cpu(extra, tmp_path, monkeypatch):
    """``--engine scan --device cpu`` writes one FrameResult per transition
    (the dataset factory is swapped for a short sequence)."""
    monkeypatch.chdir(tmp_path)
    from mav_detection_tpu_torch.core import config as cfgmod

    monkeypatch.setattr(
        cfgmod.RunConfig, "get_dataset",
        lambda self, **_: SyntheticDataset(params=SyntheticParams(**SMALL),
                                      materialize_to=str(tmp_path)))
    cli_main(["--dataset", "synthetic", "--flow-source", "FARNEBACK", "--engine",
              "scan", "--headless", "--device", "cpu", "--foe-samples", "200", *extra])
    results = tmp_path / "synthetic" / "forward-flight" / "results"
    assert len(list(results.glob("image_*.json"))) == SMALL["n_frames"] - 1
    assert (results / "foe_sparse.npy").exists() == bool(extra)
    logging.getLogger("main").setLevel(logging.INFO)
    logging.getLogger("mav_detection_tpu_torch").setLevel(logging.NOTSET)

"""The port's Processor held to the JAX package's on a synthetic 48x64
sequence: 6 frames, batch 2, so the third batch is a padded tail.

The JAX processor draws FoE samples from per-batch keys (PRNGKey(0), one
split per batch, one key per frame); the test rebuilds those draws and feeds
them to the port through ``run_detection_foe(sample_yx=...)``.
"""
import json

import numpy as np
import pytest

import jax

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.ops.flow import tuned_flow_params as j_tuned
from mav_detection_tpu.pipeline.processor import Processor as JProcessor

from mav_detection_tpu_torch.cli.main import main as cli_main
from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.pipeline.processor import Processor, _edge_pad_batch

SMALL = dict(height=48, width=64, n_frames=6, expansion=0.08, foe=(30.0, 20.0),
             drone_radius=5, drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))
BATCH = 2
N_PAIRS = SMALL["n_frames"] - 1


def jax_batch_samples(n_pairs, batch, n_samples, h, w):
    """The JAX processor's per-batch FoE draws (processor.py key schedule)."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(0, n_pairs, batch):
        key, sub = jax.random.split(key)
        per = []
        for k in jax.random.split(sub, batch):
            ky, kx = jax.random.split(k)
            per.append(np.stack([
                np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
                np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
        out.append(np.stack(per))
    return out


def run_jax(flow_source, farneback=None):
    cfg = JRunConfig(dataset="synthetic", flow_source=flow_source, batch_size=BATCH)
    cfg.get_dataset = lambda: JSynth(params=JParams(**SMALL))
    proc = JProcessor(cfg)
    proc.save_images = False
    if farneback is not None:
        proc._farneback = farneback
    return proc.run_detection_foe()


def port_processor(flow_source, **cfg_kw):
    cfg = RunConfig(dataset="synthetic", flow_source=flow_source,
                    batch_size=BATCH, **cfg_kw)
    cfg.get_dataset = lambda: SyntheticDataset(params=SyntheticParams(**SMALL))
    return Processor(cfg, device="cpu")


def run_port(flow_source):
    syx = jax_batch_samples(N_PAIRS, BATCH, 1000, SMALL["height"], SMALL["width"])
    return port_processor(flow_source).run_detection_foe(sample_yx=syx)


def _vals(fr):
    return {k: np.asarray(v, np.float64) for k, v in fr.to_dict().items()}


def test_precomputed_json_fields_match():
    """(a) Both processors read the same GT flow: every JSON field within
    1e-5 (relative for the FoE, whose line intersections XLA computes with
    fused multiply-adds)."""
    ref, got = run_jax("PRECOMPUTED"), run_port("PRECOMPUTED")
    assert sorted(got) == sorted(ref) == list(range(N_PAIRS))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=f"frame {i} {k}")


def test_farneback_json_fields_match():
    """(b) Both run the tuned fused-iteration Farneback (the JAX side's
    kernel in interpret mode). Flow differs at fp level (XLA's FMAs, matmul
    order), which can flip pixels sitting on a threshold: FoE within 0.5 px,
    rates within 0.02, everything else within 1e-3."""
    ref = run_jax("FARNEBACK", farneback=j_tuned(SMALL["height"], SMALL["width"]))
    got = run_port("FARNEBACK")
    assert sorted(got) == sorted(ref) == list(range(N_PAIRS))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            tol = {"foe_dense": 0.5, "tpr": 0.02, "fpr": 0.02, "tpr_fixed": 0.02,
                   "fpr_fixed": 0.02}.get(k, 1e-3)
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_json_written_and_tail_padded(tmp_path):
    proc = port_processor("FARNEBACK")
    proc.dataset.seq_path = str(tmp_path)
    proc.dataset.results_path = str(tmp_path / "results")
    res = proc.run_detection_foe()
    assert sorted(res) == list(range(N_PAIRS))       # padded lanes dropped
    for i, fr in res.items():
        text = (tmp_path / "results" / f"image_{i:05d}.json").read_text()
        assert text == fr.to_json()
        assert json.dumps(FrameResult.from_dict(json.loads(text)).to_dict()) == \
            json.dumps(fr.to_dict())
    assert proc.tracer.counts["flow"] == 3


def test_seeded_draw_repeats():
    proc = port_processor("PRECOMPUTED")
    a = {i: fr.foe_dense for i, fr in proc.run_detection_foe().items()}
    b = {i: fr.foe_dense for i, fr in proc.run_detection_foe().items()}
    assert a == b


def test_edge_pad_batch():
    arr = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(_edge_pad_batch(arr, 2)[3:], [[4, 5], [4, 5]])
    assert _edge_pad_batch(arr, 0) is arr


@pytest.mark.parametrize("kw,attr", [
    (dict(engine="scan"), None), (dict(devices=2), None),
    (dict(algorithm="HOMOGRAPHY"), "run_detection"),
    (dict(flow_source="RAFT"), "run_detection_foe"),
    ({}, "save_images")])
def test_unported_paths_raise(kw, attr, tmp_path):
    flow_source = kw.pop("flow_source", "FARNEBACK")
    if attr is None:
        with pytest.raises(NotImplementedError):
            port_processor(flow_source, **kw)
        return
    proc = port_processor(flow_source, **kw)
    if attr == "save_images":
        proc.save_images = True
        proc.dataset.seq_path = str(tmp_path)
        proc.dataset.results_path = str(tmp_path / "results")
        with pytest.raises(NotImplementedError, match="visualize"):
            proc.run_detection_foe()
        return
    with pytest.raises(NotImplementedError):
        getattr(proc, attr)()


def test_cli_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SYNTHETIC_PATH", str(tmp_path))
    pytest.importorskip("imageio")
    cli_main(["--dataset", "synthetic", "--flow-source", "FARNEBACK",
              "--headless", "--device", "cpu", "--batch-size", "8",
              "--foe-samples", "200"])
    results = sorted((tmp_path).rglob("results/image_*.json"))
    assert len(results) == SyntheticParams().n_frames - 1


@pytest.mark.parametrize("argv", [
    ["--dataset", "midgard"], ["--engine", "scan"], ["--validate"],
    ["--flow-source", "RAFT"], ["--algorithm", "HOMOGRAPHY"],
    ["--sequence", "x"], ["--devices", "2"]])
def test_cli_unported_flags_raise(argv):
    base = ["--dataset", "synthetic", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli_main(base + argv)

"""The port's Validator against the JAX package's: the binned statistics,
the FoE stats and ``validation.npy`` on the same results JSON, TinyYOLO
validation over a small synthetic sequence with the shipped weights, the
box-string protocol and its cache, and the two divergences by design: the
figures skipped without matplotlib, and npz-only remote media.

Tolerances: the statistics and ``validation.npy`` are the same numpy code on
the same JSON, so equal (NaN where NaN). NN validation: mean IoU within
NN_IOU_TOL of the JAX Validator's and the detection rate within one frame
(the product bf16 rounds at other points in XLA and torch, and FLOW_FOE_YOLO
fits on its own RANSAC draws)."""
import http.server
import json
import logging
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.eval import validator as jv

from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.eval import validator as tv
from mav_detection_tpu_torch.models import pretrained

torch.set_num_threads(1)

NN_IOU_TOL = 0.05
SMALL = dict(height=128, width=160, n_frames=5, drone_radius=10)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(99)


@pytest.mark.parametrize("n", [50, 400])
def test_binned_mean_std_matches_jax(rng, n):
    x = rng.uniform(-200, 10, n)
    y = rng.uniform(0, 1, n)
    y[rng.random(n) < 0.2] = np.nan
    for bins in (np.linspace(-180, 0, 40), np.linspace(0, 5.2e-4, 30)):
        np.testing.assert_array_equal(tv.binned_mean_std(x, y, bins),
                                      jv.binned_mean_std(x, y, bins))


def _write_results(path, rng, n):
    """``n`` FrameResult JSON files with random fields, some NaN, a few
    without a GT FoE and a few FoE outliers."""
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        fr = FrameResult(
            time=i * 0.05, tpr=float(rng.uniform()), fpr=float(rng.uniform(0, 6e-4)),
            tpr_fixed=float(rng.uniform()), fpr_fixed=float(rng.uniform(0, 6e-4)),
            sky_tpr=float(rng.uniform()), sky_fpr=float(rng.uniform()),
            drone_size_pixels=float(rng.uniform(20, 400)),
            drone_flow_pixels=tuple(rng.normal(0, 3, 2)),
            foe_dense=tuple(rng.normal(160, 30, 2)), foe_gt=tuple(rng.normal(160, 5, 2)),
            center_phi=float(rng.uniform(-180, 0)))
        if i % 7 == 3:
            fr.tpr = float("nan")
            fr.drone_flow_pixels = (float("nan"), float("nan"))
        if i % 11 == 5:
            fr.foe_gt = (float("nan"), float("nan"))
        with open(os.path.join(path, f"image_{i:05d}.json"), "w") as f:
            f.write(fr.to_json())


def _npy_equal(a, b):
    assert a.shape == b.shape
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x, np.float64), np.asarray(y, np.float64))


@pytest.mark.parametrize("n", [21, 71])
def test_foe_stats_and_validation_npy_match_jax(tmp_path, rng, n):
    """71 results: past FOE_STABILIZE_FRAME, so only frames 56.. count."""
    _write_results(str(tmp_path / "results"), rng, n)
    out = {}
    for tag, cls, cfg in (("jax", jv.Validator, JRunConfig(dataset="synthetic")),
                          ("port", tv.Validator, RunConfig(dataset="synthetic"))):
        kw = {} if tag == "jax" else {"device": "cpu"}
        v = cls(cfg, **kw)
        seq = tmp_path / tag
        seq.mkdir()
        v.dataset = SimpleNamespace(N=n + 1, results_path=str(tmp_path / "results"),
                                    seq_path=str(seq))
        v.load_results()
        stats = v.compute_foe_stats()
        roc = v.plot_roc()
        out[tag] = (stats, roc, np.load(seq / "validation.npy", allow_pickle=True))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0]["foe_mean"] is not None
    assert out["port"][1] == out["jax"][1]
    _npy_equal(out["port"][2], out["jax"][2])


def test_init_and_host_as_the_reference(monkeypatch):
    cfg = RunConfig(dataset="synthetic")
    monkeypatch.delenv("YOLO_INFERENCE_HOST", raising=False)
    a, b = tv.Validator(cfg, device="cpu"), jv.Validator(JRunConfig(dataset="synthetic"))
    assert a.host == b.host == "http://127.0.0.1:8099"
    assert a.frames == b.frames == {} and a.foe_error.shape == b.foe_error.shape == (0, 2)
    monkeypatch.setenv("YOLO_INFERENCE_HOST", "http://example.invalid:1")
    assert tv.Validator(cfg, device="cpu").host == "http://example.invalid:1"
    assert tv.Validator(cfg, host="http://h:2", device="cpu").host == "http://h:2"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tv.Validator(cfg)


def test_parse_frames_get_hash_and_check_cache_match_jax(tmp_path):
    raw = {"0": ["drone 0.9876 10.25 20.50 12.00 14.75"], "3": [],
           "4": ["drone 0.5100 -3.00 1.00 48.00 40.00", "drone 0.6 1 2 3 4"]}
    got, ref = tv.Validator.parse_frames(raw), jv.Validator.parse_frames(raw)
    assert sorted(got) == sorted(ref) == [0, 3, 4]
    for k in got:
        for (n1, c1, r1), (n2, c2, r2) in zip(got[k], ref[k]):
            assert (n1, c1, r1.topleft, r1.size) == (n2, c2, r2.topleft, r2.size)
    f = tmp_path / "media.bin"
    f.write_bytes(os.urandom(3 << 20))
    cfg = RunConfig(dataset="synthetic")
    v, j = tv.Validator(cfg, device="cpu"), jv.Validator(JRunConfig(dataset="synthetic"))
    assert v.get_hash(str(f)) == j.get_hash(str(f))
    assert v.check_cache("abc", str(tmp_path / "boxes")) == (None, str(tmp_path / "boxes/abc.json"))
    (tmp_path / "boxes" / "abc.json").write_text(json.dumps(raw))
    assert v.check_cache("abc", str(tmp_path / "boxes"))[0] == raw
    assert j.check_cache("abc", str(tmp_path / "boxes"))[0] == raw


def _configs(tmp_path, mode):
    j = JRunConfig(dataset="synthetic", mode=mode, validate=True, headless=True)
    j.get_dataset = lambda: JSynth(params=JParams(**SMALL),
                                   materialize_to=str(tmp_path / "jax"))
    t = RunConfig(dataset="synthetic", mode=mode, validate=True, headless=True)
    t.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(**SMALL),
                                                 materialize_to=str(tmp_path / "port"))
    return j, t


@pytest.mark.parametrize("mode", ["FLOW_UV", "FLOW_FOE_YOLO"])
def test_nn_validation_matches_jax(tmp_path, monkeypatch, mode):
    """TinyYOLO with the shipped per-mode weights over the mode imagery of a
    5-frame 128x160 sequence: IoU stats within NN_IOU_TOL of the JAX
    Validator's; the box cache lands under bounding-boxes/, keyed by the
    checkpoint's sha1, N and the mode, and parses back to every frame."""
    monkeypatch.delenv("YOLO_INFERENCE_HOST", raising=False)
    jcfg, tcfg = _configs(tmp_path, mode)
    j = jv.Validator(jcfg)
    j.dataset = jcfg.get_dataset()
    ref = j.run_nn_validation()
    v = tv.Validator(tcfg, device="cpu")
    v.dataset = tcfg.get_dataset()
    got = v.run_nn_validation()
    assert abs(got["iou_mean"] - ref["iou_mean"]) <= NN_IOU_TOL, (got, ref)
    assert abs(got["detection_rate"] - ref["detection_rate"]) <= 1 / SMALL["n_frames"] + 1e-9
    assert os.path.exists(os.path.join(v.dataset.seq_path, "ious.png"))
    cache_dir = os.path.join(v.dataset.seq_path, "bounding-boxes")
    cached = os.listdir(cache_dir)
    ckpt = pretrained.resolve_yolo_checkpoint(mode)
    assert cached == [f"{v.get_hash(ckpt)}-{SMALL['n_frames']}-{mode}.json"]
    assert cached == os.listdir(os.path.join(j.dataset.seq_path, "bounding-boxes"))
    with open(os.path.join(cache_dir, cached[0])) as f:
        raw = json.load(f)
    assert set(tv.Validator.parse_frames(raw)) == set(range(SMALL["n_frames"]))
    # a second run reads the cache
    v.run_local_inference = None
    assert tv.Validator.run_local_inference(v, v.dataset) == raw


def test_perfect_detector_iou_is_one(tmp_path, monkeypatch):
    _, tcfg = _configs(tmp_path, "FLOW_FOE_YOLO")
    monkeypatch.delenv("YOLO_INFERENCE_HOST", raising=False)
    v = tv.Validator(tcfg, device="cpu")
    v.dataset = tcfg.get_dataset()

    def perfect(dataset, score_threshold=0.5):
        out = {}
        for i in range(dataset.N):
            r = dataset.get_annotation(i)[0]
            tl = r.get_topleft()
            out[str(i)] = [f"drone 0.99 {tl[0]:.2f} {tl[1]:.2f} {r.size[0]:.2f} {r.size[1]:.2f}"]
        return out

    monkeypatch.setattr(v, "run_local_inference", perfect)
    stats = v.run_nn_validation()
    assert stats["iou_mean"] == pytest.approx(1.0, abs=1e-6)
    assert stats["detection_rate"] == 1.0


def test_missing_checkpoint_raises(tmp_path, monkeypatch):
    _, tcfg = _configs(tmp_path, "FLOW_UV")
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path / "none"))
    pretrained.clear_cache()
    try:
        v = tv.Validator(tcfg, device="cpu")
        v.dataset = tcfg.get_dataset()
        with pytest.raises(RuntimeError, match="checkpoint"):
            v.run_local_inference(v.dataset)
    finally:
        pretrained.clear_cache()


def test_plots_skipped_without_matplotlib(tmp_path, monkeypatch, caplog):
    """With matplotlib unimportable the figures are skipped with one WARNING
    that names them; the stats, validation.npy and the box cache are the
    same as with matplotlib."""
    monkeypatch.delenv("YOLO_INFERENCE_HOST", raising=False)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for tag in ("with", "without"):
        cfg = RunConfig(dataset="synthetic", mode="FLOW_UV", validate=True)
        root = tmp_path / tag
        cfg.get_dataset = lambda root=root, **_: SyntheticDataset(
            params=SyntheticParams(**SMALL), materialize_to=str(root))
        seq = cfg.get_dataset().seq_path
        _write_results(os.path.join(seq, "results"), np.random.default_rng(5),
                       SMALL["n_frames"] - 1)
        if tag == "without":
            monkeypatch.setitem(sys.modules, "matplotlib", None)
            monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="mav_detection_tpu_torch"):
            stats = tv.Validator(cfg, device="cpu").run_validation()
        warned = [r for r in caplog.records if "matplotlib" in r.getMessage()]
        figs = sorted(p.name for p in (root / "synthetic" / "forward-flight").iterdir()
                      if p.suffix in (".png", ".eps", "") and p.is_file())
        runs[tag] = (stats, np.load(os.path.join(seq, "validation.npy"), allow_pickle=True),
                     warned, figs, os.listdir(os.path.join(seq, "bounding-boxes")))
    assert runs["with"][0] == runs["without"][0]
    assert runs["with"][0]["iou_mean"] is not None and runs["with"][0]["foe_mean"] is not None
    _npy_equal(runs["with"][1], runs["without"][1])
    assert runs["with"][2] == [] and len(runs["without"][2]) == 1
    msg = runs["without"][2][0].getMessage()
    assert all(name in msg for name in tv.FIGURES)
    assert runs["with"][3] == ["ious.png", "roc.eps", "roc.png", "sky_roc.png",
                               "tpr_vs_time.png", "tpr_vs_time_raw.png"]
    assert runs["without"][3] == []
    assert runs["with"][4] == runs["without"][4] and len(runs["with"][4]) == 1


class _SidecarHandler(http.server.BaseHTTPRequestHandler):
    """A reference-era YOLOv4 sidecar: /config carries no "media"."""

    def do_GET(self):
        body = json.dumps({"start_time": 1.0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_video_only_host_raises(tmp_path, monkeypatch):
    """A host that does not advertise npz, or MAVTPU_NN_MEDIA=video, raises
    naming MAVTPU_NN_MEDIA=npz and the missing encoder (the port has no video
    encoder); an unreachable host counts as video-only; the override wins."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _SidecarHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        host = f"http://127.0.0.1:{server.server_address[1]}"
        _, tcfg = _configs(tmp_path, "FLOW_UV")
        monkeypatch.setenv("YOLO_INFERENCE_HOST", host)
        monkeypatch.delenv("MAVTPU_NN_MEDIA", raising=False)
        v = tv.Validator(tcfg, device="cpu")
        v.dataset = tcfg.get_dataset()
        assert not v._server_accepts_npz()
        with pytest.raises(RuntimeError, match="MAVTPU_NN_MEDIA=npz.*|no video encoder"):
            v.run_nn_validation()
        with pytest.raises(RuntimeError, match="no video encoder"):
            v._nn_input_media(as_video=True)
        assert not tv.Validator(tcfg, host="http://127.0.0.1:1", device="cpu")._server_accepts_npz()
        monkeypatch.setenv("MAVTPU_NN_MEDIA", "npz")
        assert v._server_accepts_npz()
        monkeypatch.setenv("MAVTPU_NN_MEDIA", "video")
        assert not v._server_accepts_npz()
        with pytest.raises(RuntimeError, match="MAVTPU_NN_MEDIA=npz"):
            v.run_nn_validation()
    finally:
        server.shutdown()
        server.server_close()


def test_nn_input_media_is_the_mode_imagery(tmp_path):
    """The npz the remote branch posts: N frames of the mode imagery, built
    once (a second call returns the cached file)."""
    from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host

    _, tcfg = _configs(tmp_path, "FLOW_RADIAL")
    v = tv.Validator(tcfg, device="cpu")
    v.dataset = tcfg.get_dataset()
    path = v._nn_input_media()
    assert path.endswith("nn-input-flow_radial.npz")
    with np.load(path) as z:
        frames = z["frames"]
    assert frames.shape == (SMALL["n_frames"], SMALL["height"], SMALL["width"], 3)
    np.testing.assert_array_equal(frames[0], mode_image_host(
        v.dataset.get_frame(0), v.dataset.flows[0], "FLOW_RADIAL", seed=0, device="cpu"))
    mtime = os.path.getmtime(path)
    assert v._nn_input_media() == path and os.path.getmtime(path) == mtime

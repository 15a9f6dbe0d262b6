"""The port's single-card tools against the JAX package's, on the CPU:
``utils.tracing.trace_to``, ``cli/video.py``, ``cli/demo.py`` and
``eval/figures.py``."""
import builtins
import glob
import json
import os

import numpy as np
import pytest
import torch

from mav_detection_tpu.cli import demo as jdemo
from mav_detection_tpu.cli import video as jvideo
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mav_detection_tpu.data.synthetic import SyntheticParams as JSyntheticParams
from mav_detection_tpu.eval import figures as jfig
from mav_detection_tpu_torch.cli import demo as tdemo
from mav_detection_tpu_torch.cli import video as tvideo
from mav_detection_tpu_torch.data.dataset import png_decode
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.eval import figures as tfig
from mav_detection_tpu_torch.utils import trace_to

torch.set_num_threads(1)

# the fixture of tests/test_figures.py
FIXTURE = dict(height=120, width=160, n_frames=8, expansion=0.035, foe=(95.0, 55.0))


@pytest.fixture
def rng():
    return np.random.default_rng(31)


# ------------------------------------------------------------- trace_to
def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_to_without_a_dir_is_a_no_op(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    with trace_to(log_dir) as prof:
        torch.ones(3) + 1
    assert prof is None and os.listdir(tmp_path) == []


# ---------------------------------------------------------------- video
@pytest.mark.parametrize("argv", [
    ["crop", "in.mp4", "out.mp4", "--width", "640", "--height", "360", "--x", "8", "--y", "4"],
    ["crop", "in.mp4", "out.mp4", "--width", "10", "--height", "20"],
    ["skip-frames", "in.mp4", "out.mp4", "--every", "3"],
    ["skip-frames", "in.mp4", "out.mp4"],
    ["shorten", "in.mp4", "out.mp4", "--start", "00:00:02.5", "--duration", "4"],
    ["shorten", "in.mp4", "out.mp4"],
    ["pngs-to-mp4", "images/image_%05d.png", "out.mp4", "--fps", "12"],
    ["frame-count", "a b.mp4"],
    ["select-frame", "in.mp4", "f.png", "--frame", "17"],
])
def test_video_argv_equals_the_reference(argv, capsys):
    ref = jvideo.build_parser().parse_args(argv)
    got = tvideo.build_parser().parse_args(argv)
    assert got.build(got) == ref.build(ref)
    assert tvideo.main(["--dry-run"] + argv) == 0
    port_out = capsys.readouterr().out
    jvideo.main(["--dry-run"] + argv)
    assert port_out == capsys.readouterr().out


# ----------------------------------------------------------------- demo
def test_demo_png_is_the_reference_png(tmp_path):
    """The mock depth capture, colormapped and written: the port's PNG
    decodes to the reference's array, bit-equal."""
    import cv2

    from mav_detection_tpu.sim.client import MockSimClient as JMock
    from mav_detection_tpu.sim.client import Vector3 as JVector3
    from mav_detection_tpu_torch.sim.client import MockSimClient, Vector3

    jc = JMock(image_hw=(48, 64))
    jc.set_pose("Drone1", JVector3(0.0, 0.0, -30.0), 0.0)
    ref = jdemo.run_demo(jc, out_path=str(tmp_path / "ref.png"))
    tc = MockSimClient(image_hw=(48, 64))
    tc.set_pose("Drone1", Vector3(0.0, 0.0, -30.0), 0.0)
    got = tdemo.run_demo(tc, out_path=str(tmp_path / "port.png"))
    assert np.array_equal(got, ref) and ref.std() > 1.0
    port_png = cv2.imread(str(tmp_path / "port.png"))
    assert np.array_equal(port_png, cv2.imread(str(tmp_path / "ref.png")))
    assert np.array_equal(port_png, ref)
    with open(tmp_path / "port.png", "rb") as f:
        assert np.array_equal(png_decode(f.read())[..., ::-1], ref)


def test_demo_main_writes_the_png(tmp_path):
    out = str(tmp_path / "test.png")
    assert tdemo.main(["--image-size", "48x64", "--out", out]) == 0
    with open(out, "rb") as f:
        img = png_decode(f.read())
    assert img.shape == (48, 64, 3) and img.std() > 1.0


# -------------------------------------------------------------- figures
@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """FrameResult JSON of the fixture, from the port's Processor on its GT
    flow; both packages' figures read the same files."""
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.pipeline.processor import Processor

    d = tmp_path_factory.mktemp("res")
    cfg = RunConfig(dataset="synthetic", mode="FLOW_FOE_CLUSTERING",
                    flow_source="GROUND_TRUTH", headless=True)
    cfg.get_dataset = lambda **_: SyntheticDataset(
        params=SyntheticParams(**FIXTURE), materialize_to=str(d))
    proc = Processor(cfg, device="cpu")
    proc.run_detection()
    assert len(glob.glob(os.path.join(proc.dataset.results_path, "image_*.json"))) == 7
    return proc.dataset.results_path


def _eq(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _eq(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=1e-12, equal_nan=True)


def _bar_matplotlib(monkeypatch):
    real = builtins.__import__

    def fake(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


def _results_figures(mod, results_dir, out):
    return {"tpr_fpr_vs_flow": mod.tpr_fpr_vs_flow({"v1": results_dir, "v2": results_dir},
                                                   out_dir=out),
            "foe_error_histograms": mod.foe_error_histograms({"run": results_dir},
                                                             out_dir=out),
            "tpr_surface_3d": mod.tpr_surface_3d({1.0: results_dir, 3.0: results_dir},
                                                 out_dir=out),
            "published": mod.foe_error_published_comparison(
                {"center": results_dir, "other": results_dir}, out_dir=out)}


def test_results_figures_numbers_equal_the_reference(results_dir, tmp_path):
    ref = _results_figures(jfig, results_dir, str(tmp_path / "j"))
    got = _results_figures(tfig, results_dir, str(tmp_path / "t"))
    _eq(got, ref)
    for name in ("tpr_fpr_vs_flow.png", "foe-error.png", "foe-error.eps",
                 "tpr_flow_vs_phi.png"):
        assert os.path.exists(tmp_path / "t" / name), name


def test_figures_without_matplotlib_keep_every_number(results_dir, tmp_path, caplog,
                                                      monkeypatch):
    with_plots = _results_figures(tfig, results_dir, str(tmp_path / "p"))
    _bar_matplotlib(monkeypatch)
    got = _results_figures(tfig, results_dir, str(tmp_path / "t"))
    assert os.listdir(tmp_path / "t") == []
    assert caplog.text.count("matplotlib cannot be imported") == 4
    _eq(got, with_plots)
    ds = SyntheticDataset(params=SyntheticParams(**FIXTURE))
    res = tfig.radial_error_histogram(ds, n_frames=3, out_path=str(tmp_path / "r.png"))
    assert res["mag"].size > 0 and not os.path.exists(tmp_path / "r.png")
    tfig.plot_states(ds, out_path=str(tmp_path / "s.png"))
    assert not os.path.exists(tmp_path / "s.png")


def test_dataset_figures_equal_the_reference(tmp_path):
    jds = JSyntheticDataset(params=JSyntheticParams(**FIXTURE))
    ds = SyntheticDataset(params=SyntheticParams(**FIXTURE))
    ref = jfig.foe_angular_error_map(jds, n_frames=4, out_path=str(tmp_path / "j.png"))
    got = tfig.foe_angular_error_map(ds, n_frames=4, out_path=str(tmp_path / "t.png"),
                                     device="cpu")
    # the phi map's arccos in fp32 on both sides: near 0 degrees one unit in
    # the last place of the cosine is ~0.01 degrees (measured 0.0086), the
    # median far below
    assert got.shape == (120, 160) and np.median(got) < 25.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.02)
    assert np.median(np.abs(got - ref)) < 1e-4
    jr = jfig.radial_error_histogram(jds, n_frames=3, out_path=str(tmp_path / "jr.png"))
    tr = tfig.radial_error_histogram(ds, n_frames=3, out_path=str(tmp_path / "tr.png"))
    _eq(tr, jr)
    assert os.path.exists(tmp_path / "tr.png")
    tfig.plot_states(ds, out_path=str(tmp_path / "st.png"))
    assert os.path.exists(tmp_path / "st.png")
    hi, lo = tfig.radial_error_model(np.array([1.0, 8.0]))
    np.testing.assert_allclose(hi, [0.25 + 8.5, 0.25 + 1.5])
    np.testing.assert_allclose(lo, [0.25 - 8.5, 0.25 - 1.5])
    assert tfig.expected_pixel_flow(10.0, 100.0, 90.0, 1000, 30.0) == \
        jfig.expected_pixel_flow(10.0, 100.0, 90.0, 1000, 30.0)


def test_angular_map_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = SyntheticDataset(params=SyntheticParams(height=32, width=48, n_frames=3))
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tfig.foe_angular_error_map(ds, n_frames=2)


def test_remove_empty_segmentations(tmp_path):
    from mav_detection_tpu_torch.data.dataset import imwrite

    seg = tmp_path / "segs"
    seg.mkdir()
    imwrite(str(seg / "image_00000.png"), np.zeros((8, 8, 3), np.uint8))
    full = np.zeros((8, 8, 3), np.uint8)
    full[2:4] = 255
    imwrite(str(seg / "image_00001.png"), full)
    assert tfig.remove_empty_segmentations(str(seg)) == 1
    assert sorted(os.listdir(seg)) == ["image_00001.png"]

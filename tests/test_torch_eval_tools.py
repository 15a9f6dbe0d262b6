"""The evaluation tools of the port (``mav_detection_tpu_torch/tools``:
``cross_domain_eval``, ``raft_advantage_probe``, ``hires_eval``,
``foe_reference_scale``) on the CPU at small sizes, held to the reference
tools of ``tools/`` on the same inputs.

The JAX side takes minutes on the CPU (its compiles), so its numbers are
stored in ``tests/eval_tools_reference_numbers.py`` with the command that
regenerates them. Tolerances, each the one the port's tests already hold
the function to:

* Farneback EPE: 1e-3 px (a whole ``farneback_flow`` against the JAX one,
  ``tests/test_torch_solvers.py``; an EPE moves by at most the flows'
  largest difference);
* LK dense EPE: 2e-3 px (``tests/test_torch_flow_tools.py``);
* RAFT in the product's bf16: 0.2 px (``tests/test_torch_raft.py``);
* the sky net's TPR / FPR: 0.015 (bf16 masks agree on 99.5 % of the
  pixels, ``tests/test_torch_sky.py``; a rate moves by at most that 0.005
  over its class's share of the frame, a third or more here);
* TinyYOLO's best IoU: 0.005 (``tests/test_torch_train.py`` holds
  ``eval_yolo``'s mean IoU so);
* the FoE statistics on GT flow: 0.05 px (the FoE vote at fp32,
  ``tests/test_torch_airsim.py``).

The four families are held to the reference's cv2 render within 1e-3
gray levels (the two Gaussian kernels' coefficients differ in the last
bits; measured 1.4e-4).
"""
import json
import os

import numpy as np
import pytest
import torch

import bench
from eval_tools_reference_numbers import FOE_RUN, HIRES_HW, NUMBERS, foe_draws

from mav_detection_tpu_torch.tools import (
    cross_domain_eval,
    finetune_raft,
    foe_reference_scale,
    hires_eval,
    raft_advantage_probe,
)

torch.set_num_threads(1)

FB_TOL_PX = 1e-3
LK_TOL_PX = 2e-3
RAFT_BF16_TOL_PX = 0.2
SKY_RATE_TOL = 0.015
YOLO_IOU_TOL = 0.005
FOE_TOL_PX = 0.05
FAMILY_TOL = 1e-3
TOLS = {"fb_epe": FB_TOL_PX, "lk_epe": LK_TOL_PX, "raft_epe": RAFT_BF16_TOL_PX,
        "raft_drone_epe": RAFT_BF16_TOL_PX, "sky_tpr": SKY_RATE_TOL,
        "sky_fpr": SKY_RATE_TOL, "yolo_iou": YOLO_IOU_TOL}
TOOLS = (cross_domain_eval, raft_advantage_probe, hires_eval, foe_reference_scale)


@pytest.fixture
def rng():
    return np.random.default_rng(12)


def _no_nan(text):
    raise ValueError(f"not strict JSON: {text}")


def _last_json(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1], parse_constant=_no_nan)


def _assert_close(got: dict, ref: dict, tols: dict) -> None:
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= tols[k], (k, got[k], v)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_raises_without_a_card(tool):
    """The tools run on the card by default and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])


# ------------------------------------------------------------ cross domain
def test_bench_family_matches_the_jax_tool():
    """The bench family through the reference's cv2 renderer, passed in."""
    got = cross_domain_eval.bench_scene_metrics(240, 320, [1], scene=bench.make_scene,
                                                device="cpu")
    _assert_close(got, NUMBERS["bench"], TOLS)
    assert got["yolo_iou"] > 0.4      # the reference's rail: the box is found


def test_mock_sim_matches_the_jax_tool():
    got = cross_domain_eval.mock_sim_metrics(device="cpu")
    _assert_close(got, NUMBERS["sim"], TOLS)


def test_finetune_cross_domain_matches_the_jax_tool():
    from mav_detection_tpu_torch.models import pretrained

    got = finetune_raft.cross_domain(pretrained.load_raft("cpu"), scene=bench.make_scene)
    _assert_close(got, NUMBERS["finetune_cross_domain"],
                  dict.fromkeys(got, RAFT_BF16_TOL_PX))


def test_cross_domain_main_prints_strict_json(capsys, monkeypatch):
    """main runs both families and ends with its result as strict JSON
    (the scipy renderer by default)."""
    monkeypatch.setattr(cross_domain_eval, "mock_sim_metrics",
                        lambda iters, device: {"raft_epe": float("nan")})
    res = cross_domain_eval.main(["--hw", "64x96", "--seeds", "1"], device="cpu")
    last = _last_json(capsys)
    assert last["sim"] == {"raft_epe": None}
    assert last["bench"] == res["bench"] and res["bench"]["fb_epe"] < 0.25


# ------------------------------------------------------------ RAFT advantage
@pytest.mark.parametrize("hw", [(64, 96), (240, 320)])
def test_families_match_the_cv2_render(hw):
    from tools.raft_advantage_probe import make_families as ref_families

    ref, got = ref_families(*hw), raft_advantage_probe.make_families(*hw)
    assert list(got) == list(ref) == ["grating", "lowcontrast", "boundary", "control"]
    for name in ref:
        for a, b in zip(got[name], ref[name]):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=FAMILY_TOL, err_msg=name)


def test_shift_reflect_is_warp_affine_with_border_reflect(rng):
    cv2 = pytest.importorskip("cv2")
    img = rng.random((20, 30)).astype(np.float32)
    for dx, dy in ((3, 1), (4, 0), (-2, -5)):
        want = cv2.warpAffine(img, np.float32([[1, 0, dx], [0, 1, dy]]), (30, 20),
                              flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
        np.testing.assert_array_equal(raft_advantage_probe.shift_reflect(img, dx, dy), want)


def test_family_rows_match_the_jax_tool(capsys, monkeypatch):
    """The rows on the reference's own cv2 families (the same inputs):
    Farneback within 1e-3 px, RAFT within its bf16 tolerance, and the
    verdict the reference reaches."""
    from tools.raft_advantage_probe import make_families as ref_families

    monkeypatch.setattr(raft_advantage_probe, "make_families", ref_families)
    res = raft_advantage_probe.main(["--size", "240x320"], device="cpu")
    assert _last_json(capsys)["verdict"] == res["verdict"]
    assert res["warp"] == "fused"
    for row in res["rows"]:
        fb, rf = NUMBERS["families"][row["family"]]
        assert abs(row["farneback_epe"] - fb) <= FB_TOL_PX, row
        assert abs(row["raft_epe"] - rf) <= RAFT_BF16_TOL_PX, row
        assert row["raft_wins"] == (rf < raft_advantage_probe.WIN_RATIO * fb), row
    assert res["wins"] == ["grating"]
    assert res["verdict"] == "RAFT wins ['grating'] by >20%"


# ------------------------------------------------------------------ hires
def test_hires_eval_matches_the_jax_tool(capsys, monkeypatch):
    """The tool's rates and IoU against the JAX tool's; TinyYOLO's ms is
    detect_boxes end to end, as the tool times it (one call for the boxes,
    one timed on the CPU's host clock), its forward alone beside it."""
    from mav_detection_tpu_torch.models import yolo

    calls, real = [], yolo.detect_boxes
    monkeypatch.setattr(yolo, "detect_boxes", lambda *a, **k: calls.append(k) or real(*a, **k))
    h, w = HIRES_HW
    res = hires_eval.main(["--size", f"{h}x{w}"], device="cpu")
    assert len(calls) == 2
    assert res["yolo"]["ms"] > 0 and res["yolo"]["forward_ms"] > 0
    assert res["yolo"]["timer"] == res["yolo"]["forward_timer"] == "host clock"
    assert _last_json(capsys)["yolo"]["iou"] == res["yolo"]["iou"]
    ref = NUMBERS["hires"]
    assert [r["size"] for r in res["sky"]] == [f"{w}x{h}", f"{w // 2}x{h // 2}"]
    for row, (tpr, fpr) in zip(res["sky"], ref["sky"]):
        assert abs(row["tpr"] - tpr) <= SKY_RATE_TOL and abs(row["fpr"] - fpr) <= SKY_RATE_TOL
        assert row["timer"] == "host clock" and row["bound_ms"] > 0
    assert res["yolo"]["size"] == "480x256"
    assert abs(res["yolo"]["iou"] - ref["yolo_iou"]) <= YOLO_IOU_TOL
    assert res["yolo"]["iou"] > 0.3     # tests/test_hires.py's rail


def test_resize_is_jax_image_resize(rng):
    """The frames reach the nets resized as jax.image.resize resizes them
    (antialiased bilinear down, nearest for the GT)."""
    import jax
    import jax.numpy as jnp

    from mav_detection_tpu_torch.ops.image.resize import resize

    img = (rng.random((64, 120, 3)) * 255).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (16, 30, 3), "bilinear"))
    np.testing.assert_allclose(resize(torch.from_numpy(img), (16, 30)).numpy(), want,
                               atol=1e-3)
    mask = (rng.random((64, 120)) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(mask), (32, 60), "nearest"))
    np.testing.assert_array_equal(resize(torch.from_numpy(mask), (32, 60), "nearest").numpy(),
                                  want)


# ------------------------------------------------------------ FoE at scale
def test_foe_stats_match_the_jax_pipeline(capsys, tmp_path, monkeypatch):
    """The port's collection, GT flow and FoE loop, fed the JAX processor's
    draws, against the JAX pipeline on its own collection and GT flow, at a
    cut where the statistics are 25x and more the tolerance and the
    validator's frames >= 56 rule drops frames; the collection goes to a
    temporary directory and SIMDATA_PATH comes back."""
    monkeypatch.setenv("SIMDATA_PATH", "/elsewhere")
    (h, w), n, b = FOE_RUN["hw"], FOE_RUN["frames"], FOE_RUN["batch"]
    ref = NUMBERS["foe"]
    assert min(abs(x) for x in ref["foe_mean"] + ref["foe_std"]) > 20 * FOE_TOL_PX
    res = foe_reference_scale.main(["--frames", str(n), "--hw", f"{h}x{w}", "--batch", str(b),
                                    "--keep", str(tmp_path / "seq")],
                                   device="cpu", sample_yx=foe_draws())
    assert os.environ["SIMDATA_PATH"] == "/elsewhere"
    assert _last_json(capsys)["ours_mean"] == res["ours_mean"]
    assert res["frames"] == ref["frames"] == n
    assert res["scoring_frames"] == ref["scoring_frames"] < n - 1
    np.testing.assert_allclose(res["ours_mean"], ref["foe_mean"], atol=FOE_TOL_PX)
    np.testing.assert_allclose(res["ours_std"], ref["foe_std"], atol=FOE_TOL_PX)
    assert res["reference_mean"] == [2.81, -7.18]
    with pytest.raises(FileExistsError):
        foe_reference_scale.collect(str(tmp_path / "seq"), h, w, n)


def test_foe_tool_removes_its_temporary_collection(capsys, monkeypatch, tmp_path):
    made = []
    real = foe_reference_scale.tempfile.mkdtemp

    def mkdtemp(**kw):
        made.append(real(dir=tmp_path, **kw))
        return made[-1]

    monkeypatch.setattr(foe_reference_scale.tempfile, "mkdtemp", mkdtemp)
    res = foe_reference_scale.main(["--frames", "3", "--hw", "32x48"], device="cpu")
    assert len(made) == 1 and not os.path.exists(made[0])
    assert res["scoring_frames"] == 2 and _last_json(capsys)["frames"] == 3


def test_foe_stats_without_inliers_print_null(capsys, monkeypatch):
    """compute_foe_stats' None means (no inliers) come out as null."""
    monkeypatch.setattr(foe_reference_scale, "foe_stats", lambda *a, **k: (
        {"foe_mean": None, "foe_std": None, "foe_outliers": 2}, 2, 3))
    monkeypatch.setattr(foe_reference_scale, "collect", lambda *a: "seq")
    res = foe_reference_scale.main(["--frames", "3"], device="cpu")
    last = _last_json(capsys)
    assert res["ours_mean"] is None and last["ours_mean"] is None and last["outliers"] == 2

"""The flow tools of the port (``mav_detection_tpu_torch/tools``: the stage
probes and sweeps of ``tools/``) on the CPU at small sizes, held to the JAX
package's functions where the tool reports an accuracy.

Each tool's ``main(argv, device="cpu")`` runs and returns its keys with
finite numbers (``None`` where the tool says a number was not taken), and
prints strict JSON as its last line. Beyond that:

* the stage probe's stages compose to ``farneback_flow_batch``'s flow
  exactly, on the layers ``_farneback_cf`` launches on;
* the sweeps' EPE against GT equals the EPE of the JAX package's
  ``farneback_flow`` with the same ``FarnebackParams`` and the separable
  warp (which the fused iteration matches), within the 1e-3 px the port's
  Farneback tests hold whole solvers to (the EPE moves by at most the
  flows' largest difference); their ``epe_cv2`` equals the EPE against a
  cv2 oracle computed here;
* RAFT's batch paths equal their single-pair calls within RAFT's fp32
  tolerance (1e-3 px, ``tests/test_torch_raft.py``);
* LK's track and dense EPE equal those of the JAX package's LK functions on
  the same scene and corners;
* on two gloo ranks, the spatial flow is within the reference's 1e-3 px of
  the unsharded flow.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mav_detection_tpu.ops.flow import farneback as jf
from mav_detection_tpu.ops.flow import lucas_kanade as jlk
from mav_detection_tpu_torch.ops.flow import farneback as fb
from mav_detection_tpu_torch.tools import (
    common,
    hires_flow_sweep,
    hires_lk_probe,
    hires_pipeline_probe,
    hires_raft_probe,
    iter_schedule_sweep,
    pipeline_stage_probe,
    raft_stage_probe,
    spatial_probe,
)

torch.set_num_threads(1)

TOOLS = (pipeline_stage_probe, iter_schedule_sweep, hires_flow_sweep, hires_pipeline_probe,
         raft_stage_probe, hires_raft_probe, hires_lk_probe, spatial_probe)
WHOLE_SOLVER_TOL_PX = 1e-3
RAFT_FP32_TOL_PX = 1e-3
LK_EPE_TOL_PX = 2e-3       # tracks agree within 1e-2 px each (test_torch_lucas_kanade)


def _no_nan(text):
    raise ValueError(f"not strict JSON: {text}")


def _last_json(capsys) -> dict:
    """The tool's last printed line, parsed as strict JSON."""
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1], parse_constant=_no_nan)


def _finite(obj, path="") -> None:
    """Every number in ``obj`` is finite (None stands for not taken)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _finite(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        assert np.isfinite(obj), path


def _oracle(prev8, curr8):
    cv2 = pytest.importorskip("cv2")
    return cv2.calcOpticalFlowFarneback(prev8, curr8, None, 0.4, 1, 12, 10, 8, 1.2, 0)


def _jax_epe(prev8, curr8, gt, **params) -> float:
    flow = np.asarray(jf.farneback_flow(jnp.asarray(prev8, jnp.float32),
                                        jnp.asarray(curr8, jnp.float32),
                                        jf.FarnebackParams(warp="separable", **params)))
    return common.epe(flow, gt)


# ------------------------------------------------------------------ common
def test_strict_json_writes_null_for_nan():
    assert common.dumps({"a": float("nan"), "b": [np.float32(1.5), np.inf],
                         "c": np.int64(3), "d": np.bool_(True)}) == \
        '{"a": null, "b": [1.5, null], "c": 3, "d": true}'


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_raises_without_a_card(tool):
    """The tools run on the card by default and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])


def test_scene_is_the_bench_scene_at_752x480():
    from mav_detection_tpu_torch.data.scene import bench_scene, make_scene

    a, b = common.scene(480, 752, False), make_scene(0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = bench_scene(0, 480, 752)
    assert all(np.array_equal(x, y) for x, y in zip(a, c[:3]))


# ------------------------------------------------------------- stage probe
def test_layer_shapes_against_the_jax_tool():
    """At the tool's 752x480 the layers _farneback_cf runs on are the JAX
    tool's round(H * 0.5**k); at 40x64 _pyramid_scales drops the coarsest
    (min(h, w) * 0.25 < 2 * poly_n + 1), which the JAX tool does not."""
    p = pipeline_stage_probe.PARAMS
    assert pipeline_stage_probe.layer_shapes(480, 752, p) == \
        pipeline_stage_probe.jax_tool_shapes(480, 752, p) == [(480, 752), (240, 376), (120, 188)]
    assert pipeline_stage_probe.layer_shapes(40, 64, p) == [(40, 64), (20, 32)]
    assert pipeline_stage_probe.jax_tool_shapes(40, 64, p) == [(40, 64), (20, 32), (10, 16)]


def test_pipeline_stage_probe_on_cpu(capsys, monkeypatch):
    """The stages compose to farneback_flow_batch's flow, on the shapes the
    pipeline launches the iterate on."""
    launched = []
    real = fb.farneback_iterate

    def spy(R0, *args, **kw):
        launched.append(tuple(R0.shape[-2:]))
        return real(R0, *args, **kw)

    monkeypatch.setattr(fb, "farneback_iterate", spy)
    prev = torch.rand(1, 40, 64, generator=torch.Generator().manual_seed(0)) * 255
    fb.farneback_flow_batch(prev, prev.flip(2), pipeline_stage_probe.PARAMS, "cpu")
    assert launched[::-1] == pipeline_stage_probe.layer_shapes(40, 64,
                                                               pipeline_stage_probe.PARAMS)

    res = pipeline_stage_probe.main(["40", "64"], device="cpu")
    assert _last_json(capsys)["composed_equal"] is True
    assert res["composed_equal"] and not res["layers_agree_with_jax_tool"]
    assert res["layers"] == ["40x64", "20x32"]
    _finite(res)
    for row in res["batches"]:
        assert row["composed_equal"] and row["launches_per_call"] == 12
        assert row["pipeline_ms"] > 0 and row["preproc_ms"] > 0
        assert row["preproc_share_of_bound"] is None          # no card's bound on the CPU
        assert row["residual_ms"] == pytest.approx(
            row["pipeline_ms"] - row["iterate_ms"] - row["preproc_ms"])
        assert [lv["shape"] for lv in row["layers"]] == res["layers"]


def test_staged_flow_equals_the_pipeline():
    g = torch.Generator().manual_seed(1)
    prev, curr = torch.rand(2, 2, 48, 80, generator=g) * 255
    for params in (pipeline_stage_probe.PARAMS, fb.tuned_flow_params(48, 80)):
        assert torch.equal(pipeline_stage_probe.staged_flow(prev, curr, params),
                           fb.farneback_flow_batch(prev, curr, params, "cpu"))


def test_preproc_bound_against_hand_count():
    """One 8x16 layer (levels 0, no resize): 2 frames x 2 x (8*16*3 +
    8*16*3 + 9*17*8*16) fp32 operations, the 3-tap smooth down and along,
    then the three vertical moments and six horizontal products of 17 taps;
    bytes: the frames, R0, R1 and the border."""
    p = fb.FarnebackParams(levels=0, iterations=1)
    ops = 2 * 2 * (8 * 16 * 3 + 8 * 16 * 3 + 9 * 17 * 8 * 16)
    nbytes = 4 * (2 * 8 * 16 + 2 * 5 * 8 * 16 + 8 * 16)
    from mav_detection_tpu_torch.utils.timing import bound_ms

    assert pipeline_stage_probe.preproc_bound(1, 8, 16, p) == bound_ms(nbytes, ops)


# ------------------------------------------------------------------ sweeps
def test_iter_schedule_sweep_matches_jax(capsys):
    h, w = 48, 80
    prev8, curr8, gt = common.scene(h, w, False)
    oracle = _oracle(prev8, curr8)
    res = iter_schedule_sweep.main(["--size", f"{h}x{w}", "--batch", "2", "--schedules",
                                    "flat;6,6,6;2,3,8"], device="cpu", oracle=oracle)
    assert _last_json(capsys)["identity_equal"] is True
    _finite(res)
    rows = {tuple(r["level_iters"]) if r["level_iters"] else None: r for r in res["rows"]}
    for sched in (None, (2, 3, 8)):
        row = rows[sched]
        assert row["ms_per_frame"] > 0 and row["flow_ms_per_frame"] > 0 and row["fps"] > 0
        ref = _jax_epe(prev8, curr8, gt, levels=2, pyr_scale=0.5, iterations=6,
                       max_shift=8, level_iters=sched)
        assert abs(row["epe_gt"] - ref) < WHOLE_SOLVER_TOL_PX
        ours = fb.farneback_flow(prev8, curr8, dataclasses.replace(
            fb.tuned_flow_params(h, w), level_iters=sched), "cpu").numpy()
        assert row["epe_cv2"] == pytest.approx(common.epe(ours, oracle))
    assert rows[None]["epe_gt"] == rows[(6, 6, 6)]["epe_gt"]


def test_iter_schedule_sweep_without_oracle_or_timing(capsys):
    res = iter_schedule_sweep.main(["--size", "40x64", "--no-timing", "--schedules", "4,4,8"],
                                   device="cpu")
    line = _last_json(capsys)
    (row,) = res["rows"]
    assert row["epe_cv2"] is None and row["ms_per_frame"] is None and row["fps"] is None
    assert line["rows"][0]["epe_cv2"] is None and res["identity_equal"] is None
    assert iter_schedule_sweep.parse_schedules("3,4,8; flat") == [(3, 4, 8), None]


def test_hires_flow_sweep_matches_jax(capsys):
    h, w = 64, 120
    prev8, curr8, gt = common.scene(h, w, True)
    oracle = _oracle(prev8, curr8)
    res = hires_flow_sweep.main(["--size", f"{h}x{w}", "--batch", "1", "--levels", "2,3",
                                 "--max-shift", "8"], device="cpu", oracle=oracle)
    assert _last_json(capsys)["ranked"]
    _finite(res)
    for pt in res["points"]:
        assert pt["gate_pass"] and pt["ms_b1"] > 0 and pt["flow_ms_b1"] > 0
        ref = _jax_epe(prev8, curr8, gt, levels=pt["levels"], pyr_scale=0.5, iterations=6,
                       max_shift=pt["max_shift"])
        assert abs(pt["epe_gt"] - ref) < WHOLE_SOLVER_TOL_PX
        ours = fb.farneback_flow(prev8, curr8, hires_flow_sweep.point_params(
            pt["levels"], pt["max_shift"]), "cpu").numpy()
        assert pt["epe_cv2"] == pytest.approx(common.epe(ours, oracle))
    assert [p["ms_b1"] for p in res["ranked"]] == sorted(p["ms_b1"] for p in res["points"])


def test_oracle_of_the_wrong_shape_is_refused():
    with pytest.raises(ValueError, match="oracle"):
        common.oracle_flow(np.zeros((4, 4, 2)), (8, 8, 2))


# ----------------------------------------------------- the product loop
def test_hires_pipeline_probe_on_cpu(capsys, tmp_path):
    res = hires_pipeline_probe.main(["--size", "48x64", "--frames", "4", "--batch", "2",
                                     "--no-images", "--data-root", str(tmp_path)],
                                    device="cpu")
    _last_json(capsys)
    _finite(res)
    assert res["frames"] == 3 and res["wall_fps"] > 0
    assert {"flow", "stage+detect"} <= set(res["stages_ms_per_call"])
    link = res["link"]
    assert link["h2d_bytes"] == link["numerator_bytes"] == hires_pipeline_probe.CANARY_BYTES
    assert link["h2d_mbps"] is None and link["d2h_mbps"] is None   # no link on the CPU
    # the sequence stays where it was put, and is reused
    assert (tmp_path / "48x64").is_dir()
    hires_pipeline_probe.materialize(str(tmp_path / "48x64"), (48, 64), 4)
    assert "already materialized" in capsys.readouterr().out


def test_link_canary_counts_the_buffer_it_moves():
    out = hires_pipeline_probe.link_canary(torch.device("cpu"), nbytes=1 << 12)
    assert out["h2d_bytes"] == out["numerator_bytes"] == 1 << 12


# -------------------------------------------------------------------- RAFT
@pytest.fixture
def raft_fp32(monkeypatch):
    """The RAFT tools in fp32, where RAFT's fp32 tolerance applies (the
    product runs bf16)."""
    from mav_detection_tpu_torch.models import raft

    monkeypatch.setattr(raft, "INFERENCE_CONFIG",
                        dataclasses.replace(raft.INFERENCE_CONFIG, dtype=torch.float32))


def test_raft_stage_probe_batch_equals_loop(capsys, raft_fp32):
    res = raft_stage_probe.main(["64", "96", "--batch", "2"], device="cpu")
    _last_json(capsys)
    _finite(res)
    bp = res["batch_paths"]
    assert bp["batch"]["finite"] and bp["loop"]["finite"]
    assert bp["max_batch_vs_loop_px"] <= RAFT_FP32_TOL_PX
    assert set(res["stages"]) == {"full iters=1", "full iters=6", "encoder (fnet x2)",
                                  "local corr volumes"}
    for t in res["stages"].values():
        assert t["ms"] > 0 and t["bound_ms"] > 0 and t["device_ms"] is None


def test_hires_raft_probe_batches_equal_single(capsys, raft_fp32):
    res = hires_raft_probe.main(["--size", "64x96", "--batches", "1,2"], device="cpu")
    _last_json(capsys)
    _finite(res)
    assert not res["saturated"] and res["first_batch_not_fitting"] is None
    for row in res["batches"]:
        assert row["finite"] and row["max_vs_single_px"] <= RAFT_FP32_TOL_PX
        assert row["ms_per_frame"] > 0 and row["peak_memory_bytes"] is None


def test_hires_raft_downscale_resizes_as_jax():
    """--downscale runs the net on frames resized as the JAX tool resizes
    them (``jax.image.resize``, linear)."""
    import jax

    h, w, d = 16, 24, 2
    img = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(0)) * 255
    small = hires_raft_probe.resize_linear_cf(img.permute(0, 3, 1, 2), (h // d, w // d))
    ref = jax.image.resize(jnp.asarray(img.numpy()), (1, h // d, w // d, 3), "linear")
    np.testing.assert_allclose(small.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-3)


# ---------------------------------------------------------------------- LK
def test_hires_lk_probe_matches_jax(capsys):
    h, w, corners = 96, 160, 200
    res = hires_lk_probe.main(["--size", f"{h}x{w}", "--corners", str(corners),
                               "--batches", "1"], device="cpu")
    _last_json(capsys)
    _finite(res)
    prev8, curr8, gt = common.scene(h, w, True)
    g0, g1 = jnp.asarray(prev8, jnp.float32), jnp.asarray(curr8, jnp.float32)
    c = jlk.shi_tomasi_corners(g0, max_corners=corners, quality_level=0.05)
    t = jlk.lucas_kanade_track(g0, g1, c.points)
    ok = np.asarray(c.valid & t.status)
    pts = np.asarray(c.points)[ok]
    disp = np.asarray(t.points - c.points)[ok]
    gt_at = gt[np.clip(pts[:, 1].astype(int), 0, h - 1), np.clip(pts[:, 0].astype(int), 0, w - 1)]
    err = np.linalg.norm(disp - gt_at, axis=-1)
    assert res["tracks"] == int(ok.sum())
    assert abs(res["track_epe_mean"] - err.mean()) < LK_EPE_TOL_PX
    dense = np.asarray(jlk.lk_dense_flow(g0, g1, max_corners=corners))
    assert abs(res["dense_epe_gt"] - common.epe(dense, gt)) < LK_EPE_TOL_PX
    (row,) = res["batches"]
    assert row["batch"] == 1 and row["ms_per_frame"] > 0


# ----------------------------------------------------------------- spatial
def test_halo_hops_follow_the_spatial_rule():
    """S 8, winsize 12: the flow halo is 16 rows; the (2, 3, 8) schedule
    refits once before each level and after all but its last iteration (at
    64x96 the pyramid has two layers; at 128x192 three)."""
    p = dataclasses.replace(fb.tuned_flow_params(64, 96), warp="separable")
    assert spatial_probe.halo_hops(64, 96, p, 1) == [(64, 96, 2), (32, 48, 3)]
    assert spatial_probe.halo_hops(128, 192, p, 1) == [(128, 192, 2), (64, 96, 3),
                                                        (32, 48, 8)]
    assert spatial_probe.halo_hops(64, 96, p, 2) == [(32, 96, 2), (16, 48, 3)]
    assert spatial_probe.halo_hops(64, 96, p, 4) == [(16, 96, 2)]


def test_spatial_probe_on_two_gloo_ranks(capsys):
    res = spatial_probe.main(["64", "96", "--meshes", "2"], device="cpu")
    _last_json(capsys)
    _finite(res)
    assert res["backend"] == "gloo" and [m["P"] for m in res["meshes"]] == [1, 2]
    for row, hops in zip(res["meshes"], (5, 5)):
        assert row["within_tol"] and row["max_abs_err_px"] <= spatial_probe.TOL_PX
        assert row["hops_per_call"] == hops and row["ms"] > 0
    assert res["meshes"][1]["hop_ms_per_call"] > 0

"""The port's headline benchmark (``mav_detection_tpu_torch.bench``) on the
CPU at small sizes, held to the repository's ``bench.py`` (the JAX
package's) where the two compute the same thing.

The module's frame size, batch and hires size are monkeypatched small, and
its amortised window shortened, so that ``main`` runs in seconds here; the
scene is the bench scene scaled to the frame (``tools.common.scene``).

Tolerances, with their reasons:
* the step (flow, then the detection step on ``bench.py``'s inputs with the
  JAX draws fed): the detector tests' (``tests/test_torch_detector.py``):
  counts and rates exact to float32 rounding (atol 1e-6), FoE and flow means
  rtol 1e-5, angles 1e-4 degrees; the flows themselves within the 1e-3 px
  the Farneback tests hold whole solvers to;
* the EPEs of ``epe_check`` against ``bench.epe_check`` on the same pair
  and cv2 oracle: 1e-4 px (the flows differ by less than 1e-3 px at any
  pixel; the mean over the interior moves far less);
* ``effective_fused_config``: equal to ``fused_schedule`` per layer.
"""
import json
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mav_detection_tpu.ops.flow import farneback as jf
from mav_detection_tpu.pipeline import detector as jdet

from mav_detection_tpu_torch import bench
from mav_detection_tpu_torch.ops.flow import effective_fused_config, tuned_flow_params
from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams
from mav_detection_tpu_torch.tools import common

torch.set_num_threads(1)

STEP_HW = (64, 96)
SMALL = dict(H=96, W=150, BATCH=2, HIRES_HW=(128, 240))
# the keys of bench.py's line, and the two the port adds
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "fps_batch8", "fps_single",
              "config", "canary_matmul_tflops", "kernel_ms_per_iter", "chip_health",
              "host", "hires"}
PORT_KEYS = {"eager", "device"}
CV2_ARGS = (0.4, 1, 12, 10, 8, 1.2, 0)


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setattr(bench, "MIN_WINDOW_S", 0.02)
    monkeypatch.setattr(bench, "EAGER_REPS", 2)
    monkeypatch.delenv("MAV_BENCH_WARP", raising=False)
    monkeypatch.delenv("MAV_BENCH_HIRES", raising=False)


def _cv2_flow(prev8, curr8):
    cv2 = pytest.importorskip("cv2")
    return cv2.calcOpticalFlowFarneback(prev8, curr8, None, *CV2_ARGS)


def _no_nan(text):
    raise ValueError(f"not strict JSON: {text}")


def _one_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0], parse_constant=_no_nan)


def _jax_samples(keys, n_samples: int, h: int, w: int) -> np.ndarray:
    """(n, 2N, 2) (y, x) indices JAX's get_foe_dense draws from ``keys``."""
    out = []
    for k in keys:
        ky, kx = jax.random.split(k)
        out.append(np.stack([
            np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
            np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
    return np.stack(out)


# -------------------------------------------------------------- (a) the step
def test_step_matches_jax_on_bench_inputs():
    """flow + detect on bench.py:187-199's inputs, the port's step against the
    JAX package's farneback_flow_batch + detect_frame_batch_scalars, the JAX
    draws of bench.py's first repetition (fold_in(PRNGKey(0), 0)) fed."""
    h, w = STEP_HW
    batch = 2
    prev8, curr8, _ = common.scene(h, w, hires=False)
    params = tuned_flow_params(h, w)
    jparams = jf.tuned_flow_params(h, w)

    a = jnp.tile(jnp.asarray(prev8, jnp.float32)[None], (batch, 1, 1))
    b = jnp.tile(jnp.asarray(curr8, jnp.float32)[None], (batch, 1, 1))
    jflow = jf.farneback_flow_batch(a, b, jparams)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), batch)
    ref = jdet.detect_frame_batch_scalars(
        jflow, jnp.zeros_like(jflow), jnp.zeros((batch, 3), jnp.float32),
        jnp.full((batch,), bench.DT, jnp.float32), jnp.zeros((batch, h, w), jnp.uint8),
        jnp.zeros((batch, h, w), bool), jnp.ones((batch, h, w), jnp.float32),
        jnp.tile(jnp.asarray([[w / 2.0, h / 2.0]], jnp.float32), (batch, 1)), keys,
        jdet.DetectionStep())

    flow, step = bench.make_step(prev8, curr8, batch, params, torch.device("cpu"))
    assert np.abs(flow().numpy() - np.asarray(jflow)).max() < 1e-3
    n = bench.DetectionStep().foe_samples
    got = step(torch.from_numpy(_jax_samples(keys, n, h, w)))
    for name in got._fields:
        g = getattr(got, name).numpy().astype(np.float64)
        r = np.asarray(getattr(ref, name)).astype(np.float64)
        if name in ("foe", "drone_flow_pixels"):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
        elif name == "center_phi":
            np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)


def test_step_draws_from_its_seeded_generator():
    """Without sample_yx the step draws from a generator seeded 0 by
    default, or from the one it is given."""
    prev8, curr8, _ = common.scene(*STEP_HW, hires=False)
    params = tuned_flow_params(*STEP_HW)
    _, s1 = bench.make_step(prev8, curr8, 2, params, "cpu")
    gen = torch.Generator().manual_seed(0)
    _, s2 = bench.make_step(prev8, curr8, 2, params, "cpu", gen)
    assert torch.equal(s1().foe, s2().foe)
    assert not torch.equal(gen.get_state(), torch.Generator().manual_seed(0).get_state())


def test_hires_flow_sweep_times_with_the_bench(monkeypatch, capsys):
    """tools.hires_flow_sweep times its points with bench.gpu_ms_per_frame,
    as tools/hires_flow_sweep.py times with bench.tpu_ms_per_frame, the eager
    figure beside it."""
    from mav_detection_tpu_torch.tools import hires_flow_sweep

    timed = []

    def fake(prev8, curr8, batch, params, dev):
        timed.append((batch, params.max_shift))
        return {"ms": 2.0 + params.levels, "eager_ms": 9.0, "replays": 3, "timer": "host clock"}

    monkeypatch.setattr(hires_flow_sweep, "gpu_ms_per_frame", fake)
    res = hires_flow_sweep.main(["--size", "64x120", "--batch", "1", "--levels", "2,3",
                                 "--max-shift", "8"], device="cpu")
    assert timed == [(1, 8), (1, 8)]
    assert [(p["ms_b1"], p["eager_ms_b1"]) for p in res["ranked"]] == [(4.0, 9.0), (5.0, 9.0)]


def test_flow_detect_ms_times_the_bench_step(monkeypatch):
    """tools.common.flow_detect_ms builds its step with bench.make_step."""
    built = []
    real = bench.make_step

    def spy(*args, **kw):
        built.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(bench, "make_step", spy)
    prev8, curr8, _ = common.scene(*STEP_HW, hires=False)
    t = common.flow_detect_ms(prev8, curr8, 2, tuned_flow_params(*STEP_HW),
                              torch.device("cpu"), reps=1)
    assert built == [2] and t["ms"] > 0 and t["flow_ms"] > 0 and t["flow_device_ms"] > 0


# ---------------------------------------------------------- (b) epe_check
def test_epe_check_matches_reference():
    """The port's epe_check and bench.py's on the same pair, the reference
    computing its cv2 oracle itself and the port given it: both EPEs within
    1e-4 px, at a size where bench.py's 0.1 px gate holds."""
    pytest.importorskip("cv2")
    import bench as reference

    h, w = STEP_HW
    prev8, curr8, gt = common.scene(h, w, hires=False)
    ref_cv2, ref_gt = reference.epe_check(prev8, curr8, gt, jf.tuned_flow_params(h, w))
    got_cv2, got_gt = bench.epe_check(prev8, curr8, gt, tuned_flow_params(h, w),
                                      oracle=_cv2_flow(prev8, curr8), dev="cpu")
    assert ref_cv2 < bench.CV2_GATE_PX
    assert abs(got_cv2 - ref_cv2) < 1e-4
    assert abs(got_gt - ref_gt) < 1e-4


def test_epe_check_without_oracle_and_its_gate():
    h, w = 60, 94
    prev8, curr8, gt = common.scene(h, w, hires=False)
    params = tuned_flow_params(h, w)
    epe_cv2, epe_gt = bench.epe_check(prev8, curr8, gt, params, None, "cpu")
    assert epe_cv2 is None and 0 < epe_gt < 0.4
    with pytest.raises(AssertionError, match="EPE vs cv2"):
        bench.epe_check(prev8, curr8, gt, params, gt + 0.5, "cpu")


# ------------------------------------------------- (c) effective_fused_config
@pytest.mark.parametrize("batch,h,w", [(8, 480, 752), (1, 480, 752), (8, 1024, 1920)])
def test_effective_fused_config_is_the_schedule(batch, h, w):
    params = tuned_flow_params(h, w)
    cfg = effective_fused_config(params, h, w, batch)      # no card: an H100's SMs
    assert cfg["warp"] == "fused" and cfg["sm_count"] == fi.H100_SMS
    assert len(cfg["layers"]) == params.levels + 1
    for k, layer in enumerate(cfg["layers"]):
        lh, lw = round(h * 0.5 ** k), round(w * 0.5 ** k)
        assert layer["shape"] == [batch, lh, lw]
        assert layer["iterations"] == params.level_iters[k]
        sched = fi.fused_schedule(batch, lh, lw, params.winsize, params.max_shift, fi.H100_SMS)
        if isinstance(sched, fi.StripGeometry):
            assert layer["design"] == "strips"
            assert (layer["strips"], layer["strip_cols"], layer["run_rows"],
                    layer["runs_per_col"], layer["blocks"], layer["smem_bytes"]) == (
                sched.strips, sched.strip, sched.rows, sched.runs_per_col, sched.blocks,
                sched.smem_bytes)
            assert layer["rows_per_step"] == fi.STRIP_ROWS
        else:
            assert layer["design"] == "tiles" and tuple(layer["tile"]) == sched
            assert layer["rows_per_step"] == fi.CHUNK_ROWS
            assert layer["smem_bytes"] == fi.tiled_smem_bytes(sched, 6, params.max_shift)
    finest = {k: v for k, v in cfg.items() if k not in ("warp", "sm_count", "layers")}
    assert finest == cfg["layers"][0]
    # every finest layer of the bench shapes streams (ops/flow/farneback_iter.py)
    assert cfg["design"] == "strips"


def test_effective_config_of_other_warps_and_no_tpu_knobs():
    assert effective_fused_config(FarnebackParams(warp="gather"), 480, 752, 8) == \
        {"warp": "gather"}
    cfg = effective_fused_config(tuned_flow_params(480, 752), 480, 752, 8)
    assert not {"halo", "band_rows_effective", "tile_cols_effective", "n_bands",
                "n_col_tiles"} & set(cfg)


@pytest.mark.parametrize("env,warp,fast", [(None, "fused", False), ("pallas", "fused", False),
                                           ("fused", "fused", False),
                                           ("separable", "separable", True),
                                           ("gather", "gather", True)])
def test_warp_from_the_environment(monkeypatch, env, warp, fast):
    """MAV_BENCH_WARP as bench.py reads it; the reference's "pallas" is the
    port's "fused", which takes the product's tuned_flow_params."""
    if env is None:
        monkeypatch.delenv("MAV_BENCH_WARP", raising=False)
    else:
        monkeypatch.setenv("MAV_BENCH_WARP", env)
    p = bench._params((480, 752))
    assert (p.warp, p.fast) == (warp, fast)
    if warp == "fused":
        assert p == tuned_flow_params(480, 752)
    else:
        assert (p.levels, p.pyr_scale, p.iterations) == (2, 0.5, 10)


# ------------------------------------------------------------- (d) the line
def test_main_on_cpu_prints_one_strict_line(small, capsys):
    res = bench.main(["--device", "cpu"], cv2_flow=_cv2_flow)
    line = _one_line(capsys)
    assert set(line) == BENCH_KEYS | PORT_KEYS
    assert line == json.loads(common.dumps(res))
    assert line["value"] > 0 and line["value"] == line["fps_batch8"]
    assert line["fps_single"] > 0 and line["vs_baseline"] > 0
    assert line["unit"] == "frames/sec/chip"
    assert "EPE vs cv2 0.0" in line["metric"] and "warp=fused" in line["metric"]
    cfg = line["config"]
    assert (cfg["batch"], cfg["warp"], cfg["timer"]) == (2, "fused", "host clock")
    assert cfg["layers"] == effective_fused_config(
        tuned_flow_params(96, 150), 96, 150, 2)["layers"]
    # the canaries time a card: not measured on the CPU
    assert line["canary_matmul_tflops"] is None and line["kernel_ms_per_iter"] is None
    assert line["chip_health"].startswith("not measured")
    hires = line["hires"]
    assert hires["resolution"] == "240x128" and hires["epe_gt"] < bench.HIRES_GATE_PX
    assert hires["baseline_ms_per_frame"] > 0 and hires["vs_baseline"] > 0
    assert hires["config"]["batch"] == 2 and hires["config"]["warp"] == "fused"
    assert set(line["eager"]) == {"fps_batch8", "fps_single", "hires_fps_batch8", "timer"}
    assert all(line["eager"][k] > 0 for k in ("fps_batch8", "fps_single", "hires_fps_batch8"))
    assert line["device"] == {"name": None, "power_limit": None}
    assert set(line["host"]) == {"cpus", "loadavg_1m", "loadavg_5m"}


def test_main_without_cv2_or_hires(small, capsys, monkeypatch):
    """No cv2_flow: EPE vs cv2 and vs_baseline null; MAV_BENCH_HIRES=0: no
    hires fields (bench.py's quick local run)."""
    monkeypatch.setenv("MAV_BENCH_HIRES", "0")
    res = bench.main(["--device", "cpu"])
    line = _one_line(capsys)
    assert set(line) == BENCH_KEYS | PORT_KEYS
    assert res["vs_baseline"] is None and line["vs_baseline"] is None
    assert "EPE vs cv2 nullpx" in line["metric"]
    assert line["hires"] is None and line["eager"]["hires_fps_batch8"] is None


def test_main_raises_without_a_card(small):
    """The bench runs on the card by default and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])


# ------------------------------------------------------- (e) unreachable
def test_unreachable_device_writes_null(small, capsys, monkeypatch):
    monkeypatch.setattr(bench, "device_reachable", lambda dev, timeout_s=0: False)
    monkeypatch.setattr(bench, "chip_health_fields", lambda dev: pytest.fail("timed"))
    res = bench.main(["--device", "cpu"])
    line = _one_line(capsys)
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["chip_health"].startswith("UNREACHABLE")
    assert res == line


def _smi_raises(exc):
    def run(cmd, *args, **kw):
        assert cmd[0] == "nvidia-smi"
        raise exc
    return run


SMI_FAULTS = {
    "called_process_error": subprocess.CalledProcessError(9, ["nvidia-smi"]),
    "file_not_found": FileNotFoundError("nvidia-smi"),
    "timeout_expired": subprocess.TimeoutExpired(["nvidia-smi"], 60),
}


@pytest.mark.parametrize("fault", [*SMI_FAULTS, "unsplittable_output"])
def test_device_fields_null_on_a_failed_query(monkeypatch, fault):
    """A card whose nvidia-smi query raises, or answers without a comma,
    gives null name and power limit; the bench does not raise there."""
    if fault == "unsplittable_output":
        monkeypatch.setattr(bench.subprocess, "run", lambda cmd, *a, **kw:
                            subprocess.CompletedProcess(cmd, 0, stdout="No devices were found\n"))
    else:
        monkeypatch.setattr(bench.subprocess, "run", _smi_raises(SMI_FAULTS[fault]))
    assert bench.device_fields(torch.device("cuda", 0)) == {"name": None, "power_limit": None}


def _on_a_card(monkeypatch, calls, reachable):
    """main on a card without one: resolve_device and the probe stubbed, the
    probe's and nvidia-smi's calls recorded in order."""
    monkeypatch.setattr(bench, "resolve_device", lambda d: torch.device("cuda", 0))

    def probe(dev, timeout_s=0):
        calls.append("probe")
        return reachable
    monkeypatch.setattr(bench, "device_reachable", probe)
    monkeypatch.setattr(bench, "chip_health_fields", lambda dev: pytest.fail("timed"))


def test_unreachable_card_with_a_failing_nvidia_smi_writes_null(small, capsys, monkeypatch):
    """C6: an unreachable card whose nvidia-smi raises still gives one strict
    UNREACHABLE line, value null, device null."""
    calls = []
    _on_a_card(monkeypatch, calls, reachable=False)
    monkeypatch.setattr(bench.subprocess, "run", _smi_raises(
        subprocess.TimeoutExpired(["nvidia-smi"], 60)))
    res = bench.main([])
    line = _one_line(capsys)
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["chip_health"].startswith("UNREACHABLE")
    assert line["device"] == {"name": None, "power_limit": None}
    assert res == line and calls == ["probe"]


def test_probe_runs_before_nvidia_smi(small, capsys, monkeypatch):
    """The reachability probe comes first, as bench.py's; the name and the
    power limit still reach the line when the query answers."""
    calls = []
    _on_a_card(monkeypatch, calls, reachable=False)

    def smi(cmd, *args, **kw):
        calls.append(cmd[0])
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
    monkeypatch.setattr(bench.subprocess, "run", smi)
    bench.main([])
    line = _one_line(capsys)
    assert calls == ["probe", "nvidia-smi"]
    assert line["device"] == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


def test_device_reachable_on_the_cpu_and_on_a_hang(monkeypatch):
    assert bench.device_reachable("cpu", timeout_s=30)

    def hang(*args, **kw):
        import time
        time.sleep(5)

    monkeypatch.setattr(bench.torch, "ones", hang)
    assert not bench.device_reachable("cpu", timeout_s=0.2)


# ------------------------------------------------------ timing and canaries
def test_amortized_follows_bench_rule(monkeypatch):
    """n grows 4x until t(n) - t(1) spans the window; the answer is that
    window over n - 1 calls."""
    monkeypatch.setattr(bench, "MIN_WINDOW_S", 0.5)
    calls = []

    def run(k):
        calls.append(k)
        return 0.01 + 0.004 * k

    s, n = bench.amortized(run, 3, 4096)
    assert n == 192 and calls == [1, 1, 3, 1, 12, 1, 48, 1, 192]
    assert s == pytest.approx(0.004)
    calls.clear()
    assert bench.amortized(run, 3, 12)[1] == 12


def test_gpu_ms_per_frame_on_cpu(small):
    prev8, curr8, _ = common.scene(48, 80, hires=False)
    t = bench.gpu_ms_per_frame(prev8, curr8, 2, tuned_flow_params(48, 80), "cpu")
    assert t["ms"] > 0 and t["eager_ms"] > 0 and t["replays"] >= 8
    assert t["timer"] == "host clock"


def test_canaries_run_on_cpu(small, monkeypatch):
    """The canaries' code on the host clock at small sizes (on the CPU the
    bench reports neither: chip_health_fields gives None)."""
    monkeypatch.setattr(bench, "CANARY_M", 32)
    assert bench.matmul_canary_s("cpu") > 0
    assert bench.kernel_ms_per_iter("cpu") > 0
    assert bench.chip_health_fields("cpu")["canary_matmul_tflops"] is None


@pytest.mark.parametrize("tflops,ms_iter,ok", [(310.0, 0.0151, True), (206.0, 0.0227, True),
                                               (12.0, 0.0151, False), (310.0, 0.41, False)])
def test_health_verdict_bands(tflops, ms_iter, ok):
    """ok inside both bands; otherwise DEGRADED, naming both readings."""
    verdict = bench.health_verdict(tflops, ms_iter)
    assert (verdict == "ok") is ok
    if not ok:
        assert verdict.startswith("DEGRADED") and f"{ms_iter:.4f}" in verdict


def test_baseline_is_cv2_then_detect_np():
    prev8, curr8, gt = common.scene(48, 80, hires=False)
    assert bench.baseline_ms(prev8, curr8) is None
    seen = []

    def flow(a, b):
        seen.append(a.shape)
        return gt

    assert bench.baseline_ms(prev8, curr8, flow) > 0
    assert seen == [(48, 80)] * 4        # 1 warm-up, 3 repetitions
    # bench.py's numpy detection gives the same count
    pytest.importorskip("cv2")
    assert bench.detect_np(gt) == _reference_detect_np(gt)


def _reference_detect_np(flow):
    """bench.py's detect_np, reached through its closure's code object."""
    import types

    import bench as reference

    code = next(c for c in reference.cv2_baseline_ms.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "detect_np")
    return types.FunctionType(code, vars(reference))(flow)


def test_hires_gate_raises(small, monkeypatch):
    monkeypatch.setattr(bench, "HIRES_GATE_PX", 1e-6)
    with pytest.raises(AssertionError, match="hires EPE vs GT"):
        bench.hires_fields(torch.device("cpu"))

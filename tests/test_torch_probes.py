"""The probe kernels' plain versions against the reference's TPU probe
kernels under ``tools/``, the probe entry points on the CPU, and the guard
that keeps chip_smoke.py's kernel table in step with every ``pl.pallas_call``
site of the repo.

The JAX side runs the tools' own kernels through ``pl.pallas_call`` with
``interpret=True``, built exactly as ``tools/gather_probe.py`` and
``tools/chain_probe.py`` build them. The CUDA kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py`` phase ``probes``).
"""
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools import chain_probe, gather_probe  # noqa: E402

from mav_detection_tpu_torch.ops.flow import farneback_iter as fi  # noqa: E402
from mav_detection_tpu_torch.ops.flow import shift_probes as sp  # noqa: E402
from mav_detection_tpu_torch.tools import batch_overhead_probe  # noqa: E402
from mav_detection_tpu_torch.tools import chain_probe as port_chain  # noqa: E402
from mav_detection_tpu_torch.tools import gather_probe as port_gather  # noqa: E402

torch.set_num_threads(1)

# The plain versions do the kernels' IEEE operations one by one; XLA's CPU
# backend contracts multiply-adds into fused ones, so the two differ by a few
# ulps of values up to ~8 in magnitude (measured at most 2.4e-7 for the shift
# kernels and 7.2e-7 for the y stage's five planes summed)
SHIFT_TOL = 1e-6
Y_STAGE_TOL = 2e-6


@pytest.fixture
def probe_rng():
    return np.random.default_rng(20)


def _jax_shift(kern, x, sy, fy, S, rows, cols, axis):
    f = pl.pallas_call(
        functools.partial(kern, S=S, rows=rows, cols=cols, axis=axis),
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(x.numpy(), sy.numpy(), fy.numpy()))


def _jax_y_stage(variant, slab, sy, fy, g, bands):
    f = pl.pallas_call(
        functools.partial(chain_probe.kern, S=g.S, mrows=g.mrows, acols=g.acols,
                          o_a=g.o_a, o_f=g.o_f, variant=variant),
        grid=(bands,),
        in_specs=[
            pl.BlockSpec((1, 5, g.sr, g.cw), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((1, g.mrows, g.acols), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, g.mrows, g.acols), lambda i: (i, 0, 0)),
        ],
        out_shape=jax.ShapeDtypeStruct((bands, 1, g.mrows, g.acols), jnp.float32),
        out_specs=pl.BlockSpec((1, 1, g.mrows, g.acols), lambda i: (i, 0, 0, 0)),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(slab.numpy(), sy.numpy(), fy.numpy()))


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kernel", ["chain", "gather"])
def test_shift_plain_versions_match_the_tool_kernels(probe_rng, S, axis, kernel):
    """shift_chain_ref / shift_gather_ref against gather_probe's chain_kernel /
    gather_kernel on a non-square plane."""
    rows, cols = 7, 13
    x, sy, fy = sp.shift_inputs(probe_rng, rows, cols, S, axis)
    kern, ref = {"chain": (gather_probe.chain_kernel, sp.shift_chain_ref),
                 "gather": (gather_probe.gather_kernel, sp.shift_gather_ref)}[kernel]
    want = _jax_shift(kern, x, sy, fy, S, rows, cols, axis)
    got = ref(x, sy, fy, S, axis)
    assert got.shape == (rows, cols)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SHIFT_TOL)


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_chain_and_gather_plain_versions_are_equal(probe_rng, S, axis):
    """For integer sy in [-S, S] only two steps of the chain carry weight, so
    the gather is the same sum exactly (the probe's exact_vs_chain)."""
    x, sy, fy = sp.shift_inputs(probe_rng, 9, 11, S, axis)
    assert torch.equal(sp.shift_chain_ref(x, sy, fy, S, axis),
                       sp.shift_gather_ref(x, sy, fy, S, axis))


@pytest.fixture(scope="module")
def y_cases():
    """Per S: the inputs, the JAX tool's output per variant A-D, and the
    plain versions' outputs per variant A-D and T (2 bands, th=4, tw=16,
    m=2)."""
    out = {}
    for S in (1, 2, 8):
        g = sp.YGeometry(S, 4, 16, 2)
        slab, sy, fy = sp.y_stage_inputs(np.random.default_rng(S), g, 2)
        jx = {v: _jax_y_stage(v, slab, sy, fy, g, 2) for v in "ABCD"}
        refs = {v: sp.y_stage_ref(slab, sy, fy, S, g.m, v) for v in sp.VARIANTS}
        out[S] = (g, jx, refs)
    return out


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_y_stage_plain_version_matches_the_tool_variant(y_cases, S, variant):
    """Each form against chain_probe's variant of the same letter; D (bf16
    taps, both sides round to nearest even) is held to JAX's D, not to A."""
    g, jx, refs = y_cases[S]
    assert refs[variant].shape == (2, 1, g.mrows, g.acols)
    np.testing.assert_allclose(refs[variant].numpy(), jx[variant], rtol=0,
                               atol=Y_STAGE_TOL)


@pytest.mark.parametrize("S", [1, 2, 8])
def test_y_stage_two_tap_form_matches_the_tool_chain(y_cases, S):
    """T, the port kernel's two-tap read, against JAX's A; and exactly equal
    to the plain A and B, as the chip check requires of the kernels."""
    g, jx, refs = y_cases[S]
    np.testing.assert_allclose(refs["T"].numpy(), jx["A"], rtol=0, atol=Y_STAGE_TOL)
    assert torch.equal(refs["T"], refs["A"]) and torch.equal(refs["B"], refs["A"])
    # C and D take another lerp and bf16 taps: not exact, D far off
    assert not torch.equal(refs["D"], refs["A"])
    assert float((refs["D"] - refs["A"]).abs().max()) > 1e-3


def test_y_stage_geometry_is_the_chain_probes():
    """P = S + 1 + m, the offsets and the block shapes at the tool's
    defaults (S=8, th=24, tw=752, m=6), as chain_probe.main computes them."""
    g = sp.YGeometry(8, 24, 752, 6)
    assert (g.P, g.o_f, g.o_a) == (15, 9, 1)
    assert (g.mrows, g.acols, g.sr, g.cw) == (36, 781, 54, 782)


def test_bounds_against_hand_counts():
    # shift: x at (3840 + 17) x 752; sy, fy and the output at the 3840 x 752
    # output cells (the kernels read no other cell of sy and fy), fp32
    assert sp.shift_bytes(3840, 752, 8, 0) == 4 * (3857 * 752 + 3 * 3840 * 752) == 46_254_016
    assert sp.shift_bytes(3840, 752, 8, 1) == 4 * (3840 * 769 + 3 * 3840 * 752) == 46_464_000
    assert sp.shift_bytes(64, 768, 8, 1) == 4 * (64 * 785 + 3 * 64 * 768)
    # y stage at the tool's default (20 bands) and at b=8 480x752 (160): the
    # slab's rows 1 .. 53 and columns 1 .. 781 (row 0 and column 0 unread)
    g = sp.YGeometry(8, 24, 752, 6)
    assert sp.y_stage_bytes(g, 20) == 4 * 20 * (5 * 53 * 781 + 3 * 36 * 781) == 23_305_040
    assert sp.y_stage_bytes(g, 160) == 186_440_320
    # on the fused kernel's 32x64 tiles, 1440 of them at b=8 480x752
    t = sp.YGeometry(8, 32, 64, 6)
    assert (t.mrows, t.acols, t.sr, t.cw) == (44, 93, 62, 94)
    assert sp.y_stage_bytes(t, 1440) == 4 * 1440 * (5 * 61 * 93 + 3 * 44 * 93) == 234_092_160
    # operations per output cell: chain 1 + 3 per step, gather 4; the y
    # stage's A 1 + 11 per step + 4 plane sums, C 19, T 20
    assert sp.shift_ops("shift_chain", 2, 3, 8) == 6 * (1 + 3 * 18)
    assert sp.shift_ops("shift_gather", 2, 3, 8) == 6 * 4
    cells = 20 * 36 * 781
    assert sp.y_stage_ops(g, 20, "A") == cells * (1 + 11 * 18 + 4)
    assert sp.y_stage_ops(g, 20, "C") == sp.y_stage_ops(g, 20, "D") == cells * 19
    assert sp.y_stage_ops(g, 20, "T") == cells * 20
    # every one bound by bytes on the H100 (3.35 TB/s against 67 TFLOP/s)
    assert sp.y_stage_ops(g, 160, "A") / 67e12 < sp.y_stage_bytes(g, 160) / 3.35e12


def test_tiled_bound_against_hand_counts():
    """The tile design at b=8 480x752 S=8 on 32x64 tiles is held to the
    iteration's own bound: bytes 4 (14 b H W + H W). Its operations with
    the halo it recomputes (a diagnostic, not the bound): per tile 36 per
    A-window cell (44x93), 73 per M-region cell (44x76), 5 x 13 taps per
    vertical (32x76) and horizontal (32x64) box sum, 18 per output, over 8 x
    15 x 12 tiles."""
    assert fi.fused_bytes(8, 480, 752) == 4 * (14 * 8 * 480 * 752 + 480 * 752) == 163_153_920
    per_tile = 36 * 44 * 93 + 73 * 44 * 76 + 5 * 13 * (32 * 76 + 32 * 64) + 18 * 32 * 64
    assert fi.tiled_ops(8, 480, 752, 12, 8, (32, 64)) == per_tile * 8 * 15 * 12
    assert fi.tiled_ops(8, 480, 752, 12, 8, (32, 64)) > 1.3 * fi.fused_ops(8, 480, 752, 12)
    ms, by = fi.fused_bound(8, 480, 752, 12)
    assert by == "bytes" and ms == pytest.approx(163_153_920 / 3.35e12 * 1e3)
    assert round(ms, 5) == 0.04870


def test_fused_bound_against_hand_counts():
    """The iteration's own bound, the same for both designs: per output
    pixel 36 operations of the y stage, 53 of the x stage and normal
    equations, 5 x 13 adds of the vertical and of the horizontal box sum,
    18 of the mean and solve; no halo. At b=8 480x752 it is bound by bytes,
    and at the coarsest b=1 layer too. The row-streaming design's own count
    with its halo (a diagnostic): 7 strips of 108 columns, the 56 strip
    columns of 480 rows laid end to end and cut every 204 rows (132
    blocks); the 55 column boundaries split a block's run but at 480 k =
    8160 k' (k = 17, 34, 51), so 132 + 52 = 184 segments, all a multiple of
    4 rows long: 26880 + 12 x 184 A and M rows, each 137 A-window cells x 36
    and 120 M cells x (53 + 5 x 13 vertical adds), and 26880 output rows of
    108 outputs x (5 x 13 horizontal adds + 18)."""
    assert fi.fused_ops(8, 480, 752, 12) == 8 * 480 * 752 * (36 + 53 + 130 + 18) == 684_380_160
    assert fi.fused_ops(1, 120, 188, 12) == 120 * 188 * 237
    ms, by = fi.fused_bound(8, 480, 752, 12)
    assert by == "bytes" and round(ms, 5) == 0.04870
    ms, by = fi.fused_bound(1, 120, 188, 12)
    assert by == "bytes" and ms == pytest.approx(4 * 15 * 120 * 188 / 3.35e12 * 1e3)
    # the operations alone take under a quarter of the bytes' time
    assert 684_380_160 / 67e12 < 0.25 * 163_153_920 / 3.35e12
    g = fi.strip_geometry(8, 480, 752, 12, 8, 132)
    assert (g.strip, g.strips, g.rows, g.runs_per_col, g.blocks) == (108, 7, 204, 0, 132)
    segs = [n for run in fi.strip_segments(8, 480, 7, 204) for n in run]
    assert len(segs) == 184 and all(n % 4 == 0 for n in segs)
    per_row = 137 * 36 + 120 * (53 + 5 * 13)
    assert fi.strip_ops(8, 480, 752, 12, 8, g) == (
        (26880 + 12 * 184) * per_row + 26880 * 108 * (5 * 13 + 18)) == 796_300_416


def test_wrappers_on_cpu_take_the_plain_versions(probe_rng):
    x, sy, fy = sp.shift_inputs(probe_rng, 5, 6, 2, 1)
    g = sp.YGeometry(2, 3, 8, 1)
    slab, ysy, yfy = sp.y_stage_inputs(probe_rng, g, 2)
    sp.reset_launch_counts()
    assert torch.equal(sp.shift_chain(x, sy, fy, 2, 1), sp.shift_chain_ref(x, sy, fy, 2, 1))
    assert torch.equal(sp.shift_gather(x, sy, fy, 2, 1), sp.shift_gather_ref(x, sy, fy, 2, 1))
    for v in sp.VARIANTS:
        assert torch.equal(sp.y_stage(slab, ysy, yfy, 2, 1, v),
                           sp.y_stage_ref(slab, ysy, yfy, 2, 1, v))
    assert sum(sp.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="device"):
        sp.shift_chain(x.to("meta"), sy, fy, 2, 1)
    with pytest.raises(ValueError, match="variant"):
        sp.y_stage(slab, ysy, yfy, 2, 1, "E")
    with pytest.raises(ValueError, match="need"):
        sp.y_stage_ref(slab, ysy[:, 1:], yfy, 2, 1, "A")


def test_gather_probe_on_cpu():
    res = port_gather.main(["--rows", "8", "--cols", "16", "--S", "2", "--reps", "2"],
                           device="cpu")
    assert res["device"] == "cpu" and [a["axis"] for a in res["axes"]] == [0, 1]
    for a in res["axes"]:
        assert a["exact_vs_chain"] is True
        assert a["bytes"] == sp.shift_bytes(8, 16, 2, a["axis"])
        for k in ("shift_chain", "shift_gather"):
            assert a[k]["us"] > 0 and a[k]["share"] is None   # no card: no share
            assert a[k]["equal_to_plain"] is True and a[k]["max_abs_err"] == 0.0
            assert a[k]["plain_ms"] > 0


def test_chain_probe_on_cpu():
    res = port_chain.main(["--S", "2", "--th", "4", "--tw", "16", "--m", "2",
                           "--bands", "2", "--reps", "2"], device="cpu")
    assert list(res["variants"]) == list(sp.VARIANTS)
    for v in port_chain.EXACT_VS_A:
        assert res["variants"][v]["max_diff_vs_A"] == 0.0
    assert res["variants"]["D"]["max_diff_vs_A"] > 1e-3
    assert res["bytes"] == sp.y_stage_bytes(sp.YGeometry(2, 4, 16, 2), 2)
    assert res["fused_y_bytes"] == 4 * 7 * 2 * 4 * 16
    assert res["sy_run"] == 1
    for r in res["variants"].values():
        assert r["equal_to_plain"] is True and r["max_abs_err"] == 0.0
        assert r["plain_ms"] > 0


def test_chain_probe_sy_run_on_cpu(capsys):
    """``--sy-run N``: sy constant over runs of N columns, each run its
    first column's draw; A, B and T stay exact, and every form is still its
    plain version."""
    argv = ["--S", "2", "--th", "4", "--tw", "16", "--m", "2", "--bands", "2",
            "--reps", "1", "--sy-run", "8"]
    res = port_chain.main(argv, device="cpu")
    assert res["sy_run"] == 8 and "sy-run 8" in capsys.readouterr().out
    for v in port_chain.EXACT_VS_A:
        assert res["variants"][v]["max_diff_vs_A"] == 0.0
    for r in res["variants"].values():
        assert r["equal_to_plain"] is True
    # the runs: the same draws as the tool's, then sy[..., a] = sy[..., a - a % 8]
    g = sp.YGeometry(2, 4, 16, 2)
    slab, sy, fy = sp.y_stage_inputs(np.random.default_rng(0), g, 2)
    a = torch.arange(g.acols)
    runs = sy[:, :, a - a % 8]
    assert torch.equal(runs[:, :, 8:16], runs[:, :, 8:9].expand(-1, -1, 8))
    assert not torch.equal(runs, sy)
    want = sp.y_stage_ref(slab, runs.contiguous(), fy, 2, 2, "T")
    assert torch.equal(sp.y_stage(slab, runs.contiguous(), fy, 2, 2, "T"), want)


def test_batch_overhead_probe_on_cpu():
    res = batch_overhead_probe.main(["24", "32"], device="cpu")
    assert (res["H"], res["W"], res["S"], res["winsize"], res["iterations"]) == (
        24, 32, 8, 12, 6)
    assert [r["b"] for r in res["batches"]] == [1, 8]
    for r in res["batches"]:
        assert r["full_ms"] > 0 and r["kernel_ms"] > 0
        assert r["glue_ms"] == pytest.approx(r["full_ms"] - r["kernel_ms"])
        assert r["geometry"] == str(fi.fused_schedule(r["b"], 24, 32, 12, 8, fi.H100_SMS))
        assert (r["bound_ms_per_launch"], r["bound_by"]) == fi.fused_bound(
            r["b"], 24, 32, 12)
        assert r["bound_ms_per_launch"] >= fi.fused_bytes(r["b"], 24, 32) / 3.35e12 * 1e3
        assert r["kernel_share_of_bound"] is None


def test_probe_entries_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    for main in (port_gather.main, port_chain.main, batch_overhead_probe.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])


def test_probe_entries_run_as_modules_on_cpu():
    """``python -m mav_detection_tpu_torch.tools.<name> --device cpu``."""
    for argv in (["gather_probe", "--rows", "4", "--cols", "8", "--S", "1", "--reps", "1"],
                 ["chain_probe", "--S", "1", "--th", "2", "--tw", "8", "--m", "1",
                  "--bands", "1", "--reps", "1"]):
        proc = subprocess.run(
            [sys.executable, "-m", f"mav_detection_tpu_torch.tools.{argv[0]}",
             *argv[1:], "--device", "cpu"], cwd=REPO, capture_output=True,
            text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "exact_vs_chain=True" in proc.stdout or "[T]" in proc.stdout


_SITE = re.compile(r"\bpl\.pallas_call\(")
_SKIP_DIRS = {"mav_detection_tpu_torch", "tests", "build"}


def _pallas_call_sites():
    sites = set()
    for path in REPO.rglob("*.py"):
        rel = path.relative_to(REPO)
        if rel.parts[0] in _SKIP_DIRS or any(p.startswith(".") for p in rel.parts):
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if _SITE.search(line):
                sites.add(f"{rel.as_posix()}:{n}")
    return sites


def test_every_pallas_call_site_has_a_kernel_row():
    """Each ``pl.pallas_call(`` of the repo outside the port and the tests
    is listed by a row of chip_smoke.KERNEL_ROWS, whose ``replaces`` names
    the TPU kernel's function: in the site's own file, or a function the
    site's file calls by name. No row lists a site that is gone."""
    code = ("import json, chip_smoke\n"
            "print(json.dumps(chip_smoke.KERNEL_ROWS))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads(proc.stdout.splitlines()[-1])
    found = _pallas_call_sites()
    assert len(found) >= 5, found
    listed = {site for row in rows.values() for site in row["sites"]}
    assert found == listed, (sorted(found - listed), sorted(listed - found))
    for site in found:
        site_file = site.rsplit(":", 1)[0]
        text = (REPO / site_file).read_text()
        ok = False
        for row in rows.values():
            if site not in row["sites"]:
                continue
            rfile, rline = row["replaces"].rsplit(":", 1)
            m = re.match(r"\s*def (\w+)\(",
                         (REPO / rfile).read_text().splitlines()[int(rline) - 1])
            assert m, f"{row['replaces']} is not the line of a function"
            ok = ok or rfile == site_file or re.search(rf"\b{m.group(1)}\(", text)
        assert ok, f"{site}: no row replaces a kernel this site runs"

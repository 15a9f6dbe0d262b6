"""The port's Farneback path held to the JAX package's on the CPU.

The JAX iterate kernel is reached through its interpret mode (Pallas on the
CPU) in two tests; everything else is held against the XLA path. Inputs are
made with numpy from a seed and fed to both packages.

Tolerances, with their reasons:
* matrix builders: bit-equal (the port's numpy code is a copy);
* fused preprocessing matmuls: 1e-5 of the coefficients' scale (fp32 sum
  order differs between XLA's dot and torch.matmul);
* plain iterate vs the Pallas kernel in interpret mode: 1e-5 px (measured
  ~2e-6: XLA on the CPU contracts a*b + c into fused multiply-adds, the port
  keeps every op separately rounded, as the CUDA kernels do with
  -fmad=false; the two-tap form itself is exact, see
  test_direct_taps_equal_tpu_chain);
* plain iterate vs the XLA separable path: 1e-4 px (box blur as matmuls);
* whole solver vs the JAX tuned configuration: 1e-3 px.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.ndimage import gaussian_filter, shift as nd_shift

from mav_detection_tpu.ops.flow import farneback as jf
from mav_detection_tpu.ops.flow.farneback_pallas import farneback_iterate_pallas

from mav_detection_tpu_torch import _build, convert
from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.flow import farneback_iter as ti


@pytest.fixture
def rng():
    """A generator of this test's own. The repository-wide ``rng`` fixture is
    one stream for the whole test run: drawing from it here would shift the
    numbers that the JAX package's tests draw after this file in the same
    worker process."""
    return np.random.default_rng(1234)


def _frames(b, h, w, seed=0, motion=((1.3, 2.1), (-0.8, 1.6), (2.5, -1.2))):
    rng = np.random.default_rng(seed)
    prev = np.stack([gaussian_filter(rng.random((h, w)), 1.5) for _ in range(b)])
    prev = ((prev - prev.min()) / np.ptp(prev) * 220 + 20).astype(np.float32)
    curr = np.stack([nd_shift(prev[i], motion[i % len(motion)], order=1,
                              mode="nearest") for i in range(b)])
    return prev, curr.astype(np.float32)


def _level_inputs(b, h, w, seed=0, flow_scale=3.0):
    """(R0, R1, flow0, border) numpy, channel-first, from the JAX builders."""
    prev, curr = _frames(b, h, w, seed)
    smooth = jf._gaussian_kernel(3, 0.0)
    R0 = np.asarray(jf._poly_exp_pyr_cf(jnp.asarray(prev), smooth, h, w, 8, 1.2))
    R1 = np.asarray(jf._poly_exp_pyr_cf(jnp.asarray(curr), smooth, h, w, 8, 1.2))
    rng = np.random.default_rng(seed + 100)
    flow0 = (gaussian_filter(rng.standard_normal((b, 2, h, w)), (0, 0, 3, 3))
             * flow_scale * 6).astype(np.float32)
    border = np.asarray(jf._border_scale_map(h, w))
    return R0, R1, flow0, border


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


class TestMatrixBuilders:
    def test_poly_exp_moments(self):
        for n, s in ((8, 1.2), (5, 1.1), (3, 0.9)):
            for a, b in zip(tf._poly_exp_moments(n, s), jf._poly_exp_moments(n, s)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("mode", ["edge", "reflect"])
    def test_band_matrix(self, mode):
        k = jf._gaussian_kernel(5, 1.1)
        for size in (7, 30, 61):
            np.testing.assert_array_equal(tf._band_matrix_np(size, k, mode),
                                          jf._band_matrix_np(size, k, mode))

    def test_resize_gaussian_border_pyramid(self):
        for src, dst in ((480, 240), (752, 188), (97, 53), (53, 97), (64, 64)):
            np.testing.assert_array_equal(tf._resize_matrix_np(src, dst),
                                          jf._resize_matrix_np(src, dst))
        for ks, s in ((3, 0.0), (5, 0.5), (9, 1.5)):
            assert tf._gaussian_kernel(ks, s) == jf._gaussian_kernel(ks, s)
        for h, w in ((480, 752), (7, 9), (45, 67)):
            np.testing.assert_array_equal(tf._border_scale_map_np(h, w),
                                          np.asarray(jf._border_scale_map(h, w)))

    def test_poly_pyr_mats(self):
        smooth = jf._gaussian_kernel(5, 0.5)
        for args in ((48, 64, 24, 32), (45, 67, 45, 67), (97, 53, 24, 13)):
            for a, b in zip(tf._poly_pyr_mats_np(*args, smooth, 8, 1.2),
                            jf._poly_pyr_mats_np(*args, smooth, 8, 1.2)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("h,w", [(480, 752), (1024, 1920), (48, 64), (30, 500)])
    def test_tuned_params_schedule_and_scales(self, h, w):
        jp = jf.tuned_flow_params(h, w)
        tp = convert.farneback_params_from_reference(dataclasses.asdict(jp))
        assert tp == tf.tuned_flow_params(h, w)
        assert tf._pyramid_scales(h, w, tp) == jf._pyramid_scales(h, w, jp)
        for k in range(4):
            assert tf._level_iter_count(tp, k) == jf._level_iter_count(jp, k)


class TestConvert:
    def test_separable_without_fast_is_the_same_algorithm(self):
        jp = jf.FarnebackParams(warp="separable", levels=2, max_shift=8)
        tp = convert.farneback_params_from_reference(dataclasses.asdict(jp))
        assert (tp.levels, tp.max_shift, tp.iterations) == (2, 8, 10)
        assert tp.warp == "separable" and not tp.fast

    @pytest.mark.parametrize("kw", [dict(warp="gather", precision="default"),
                                    dict(warp="auto", precision="default"),
                                    dict(warp="separable", fast=True,
                                         precision="default"),
                                    dict(warp="pallas", precision="default")])
    def test_unported_configurations_raise(self, kw):
        """Reduced matmul precision is the one configuration not ported
        (every warp and the fast schedule are: tests/test_torch_solvers.py)."""
        with pytest.raises(NotImplementedError):
            convert.farneback_params_from_reference(
                dataclasses.asdict(jf.FarnebackParams(**kw)))

    def test_detection_step(self):
        from mav_detection_tpu.pipeline.detector import DetectionStep as JStep

        t = convert.detection_step_from_reference(JStep(foe_samples=4000)._asdict())
        assert t.foe_samples == 4000


class TestPreproc:
    @pytest.mark.parametrize("h,w,lh,lw,ks,sig", [
        (44, 64, 44, 64, 3, 0.0), (44, 64, 22, 32, 5, 0.5), (45, 67, 11, 17, 7, 1.5)])
    def test_poly_exp_pyr_cf(self, h, w, lh, lw, ks, sig):
        prev, _ = _frames(2, h, w)
        smooth = jf._gaussian_kernel(ks, sig)
        ref = np.asarray(jf._poly_exp_pyr_cf(jnp.asarray(prev), smooth, lh, lw, 8, 1.2))
        got = tf.poly_exp_pyr_cf(torch.from_numpy(prev), smooth, lh, lw, 8, 1.2).numpy()
        assert got.shape == ref.shape == (2, 5, lh, lw)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    @pytest.mark.parametrize("src,dst", [((12, 16), (24, 32)), ((11, 17), (22, 34)),
                                         ((24, 32), (48, 64))])
    def test_level_resize(self, src, dst, rng):
        flow = rng.standard_normal((2, 2) + src).astype(np.float32) * 4
        ref = np.asarray(jf._resize_linear_cf(jnp.asarray(flow), dst))
        got = tf.resize_linear_cf(torch.from_numpy(flow), dst).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


class TestIterate:
    def test_one_iteration_matches_xla_separable(self):
        """One plain iteration == the XLA path's update_matrices(separable)
        + solve_flow (to fp32 box-blur-as-matmul noise), as the JAX kernel's
        own parity test holds it."""
        R0, R1, flow0, border = _level_inputs(2, 40, 56, seed=1)
        cl = lambda x: jnp.transpose(jnp.asarray(x), (2, 3, 0, 1))  # noqa: E731
        M = jf._update_matrices(cl(R0), cl(R1), cl(flow0), jnp.asarray(border),
                                "separable", 8)
        ref = np.transpose(np.asarray(jf._solve_flow(M, 12)), (2, 3, 0, 1))
        got = ti.farneback_iterate_ref(*_t(R0, R1, flow0, border), 1, 12, 8).numpy()
        assert np.abs(got - ref).max() < 1e-4

    def test_matches_pallas_kernel_interpret(self):
        """The plain version vs the TPU kernel itself (interpret mode):
        b=2, S=8, 3 iterations, height 44 (not a multiple of 8)."""
        R0, R1, flow0, border = _level_inputs(2, 44, 64, seed=2)
        ref = np.asarray(farneback_iterate_pallas(
            *(jnp.asarray(a) for a in (R0, R1, flow0, border)), iterations=3,
            winsize=12, max_shift=8, band_rows=24, halo="element",
            interpret=True))
        got = ti.farneback_iterate_ref(*_t(R0, R1, flow0, border), 3, 12, 8).numpy()
        assert np.abs(got - ref).max() < 1e-5

    @pytest.mark.parametrize("S", [2, 8])
    def test_direct_taps_equal_tpu_chain(self, S):
        """Reading the two live taps directly is bit-identical to the TPU
        kernel's 2S+2-step shift/select chain (restated here in torch, with
        its edge-padded planes), shifts clipped at +-S included."""
        R0, R1, flow0, border = _level_inputs(2, 23, 31, seed=3, flow_scale=4.0)
        R0, R1, flow0, border = _t(R0, R1, flow0, border)
        got = ti.update_matrices_ref(R0, R1, flow0, border, S)
        np.testing.assert_array_equal(got.numpy(),
                                      _chain_update_matrices(R0, R1, flow0, border, S).numpy())

    def test_iterate_wrapper_takes_plain_version_on_cpu(self):
        R0, R1, flow0, border = _t(*_level_inputs(1, 20, 24, seed=4))
        a = ti.farneback_iterate(R0, R1, flow0, border, 2, 12, 8)
        b = ti.farneback_iterate_ref(R0, R1, flow0, border, 2, 12, 8)
        assert torch.equal(a, b)
        assert ti.farneback_iterate(R0, R1, flow0, border, 0, 12, 8) is flow0


class TestTiledKernelBudget:
    """Shared memory of the tile design's block (farneback_iterate_fused on
    the layers too short to stream, and the yardstick), reckoned in Python
    (the wrapper refuses a launch from this before any CUDA call)."""

    @pytest.mark.parametrize("h,w", [(480, 752), (1024, 1920)])
    def test_tuned_shapes_fit_two_blocks_per_sm(self, h, w):
        p = tf.tuned_flow_params(h, w)
        nbytes = ti.tiled_launch_smem(ti.TILE, p.winsize, p.max_shift)
        assert nbytes <= 113 * 1024

    def test_bytes_count_every_buffer(self):
        # 32x64 tile, m=6: M region 44x76 (row stride 76, float4 reads),
        # A window 109 columns at S=16 and 93 at S=8; 5 planes of two 8-row
        # A chunks and of M
        assert ti.tiled_smem_bytes((32, 64), 6, 16) == 4 * 5 * (2 * 8 * 109 + 44 * 76)
        assert ti.tiled_smem_bytes((32, 64), 6, 8) == 4 * 5 * (2 * 8 * 93 + 44 * 76)
        # 32x32 (2 outputs per thread): odd row stride 45 for M 44x44
        assert ti.tiled_smem_bytes((32, 32), 6, 8) == 4 * 5 * (2 * 8 * 61 + 44 * 45)

    @pytest.mark.parametrize("win,S", [(12, 300), (12, 500), (60, 64)])
    def test_overrun_refused(self, win, S):
        assert ti.tiled_smem_bytes(ti.TILE, win // 2, S) > _build.MAX_SMEM_BYTES
        with pytest.raises(ValueError, match="shared memory"):
            ti.tiled_launch_smem(ti.TILE, win, S)

    @pytest.mark.parametrize("tile", sorted(ti.TILES))
    def test_free_max_shift_up_to_the_limit(self, tile):
        """max_shift is a free parameter: S=32 fits every tile, and the
        largest S that fits is taken, the next one refused."""
        assert ti.tiled_launch_smem(tile, 12, 32) <= _build.MAX_SMEM_BYTES
        S = max(s for s in range(512)
                if ti.tiled_smem_bytes(tile, 6, s) <= _build.MAX_SMEM_BYTES)
        assert ti.tiled_launch_smem(tile, 12, S) <= _build.MAX_SMEM_BYTES
        with pytest.raises(ValueError, match="shared memory"):
            ti.tiled_launch_smem(tile, 12, S + 1)

    @pytest.mark.parametrize("b,h,w,tile", [
        (8, 480, 752, (32, 64)), (8, 240, 376, (32, 64)), (8, 120, 188, (32, 32)),
        (2, 1024, 1920, (32, 64)), (2, 256, 480, (32, 32)), (4, 256, 480, (32, 64))])
    def test_tile_for_layer(self, b, h, w, tile):
        """132 SMs (an H100 SXM): the wide tile where every SM gets a block,
        the small one on the coarsest layers at b=8 and b=2."""
        assert ti.tile_for(b, h, w, 132) == tile

    def test_unknown_tile_refused(self):
        with pytest.raises(ValueError, match="tiles"):
            ti.tiled_launch_smem((8, 8), 12, 8)


def _product_layers():
    """Every pyramid layer of the product's two frame sizes, with the
    max_shift the product runs there: 752x480 at S = 8, 1920x1024 at 16."""
    out = []
    for h, w in ((480, 752), (1024, 1920)):
        p = tf.tuned_flow_params(h, w)
        out += [(int(round(h * sc)), int(round(w * sc)))
                for sc in tf._pyramid_scales(h, w, p)]
    return out


STRIP_CASES = [(b, h, w, S, win) for h, w in _product_layers() for b in (1, 2, 4, 8)
               for S in (8, 16) for win in (12, 9)]


def _first_at_least(n, residue):
    v = n
    while v % 32 != residue:
        v += 1
    return v


class TestStripGeometry:
    """The row-streaming kernel's launch geometry and shared memory
    (farneback_iterate_fused), reckoned in Python, at every layer of the
    product shapes, b = 1, 2, 4, 8, S = 8 and 16, winsize 12 (m = 6, compiled
    in) and 9 (the run-time-m kernel), on an H100's 132 SMs."""

    @pytest.mark.parametrize("b,h,w,S,win", STRIP_CASES)
    def test_ring_bytes_by_hand(self, b, h, w, S, win):
        """R1 ring of 2S + 1 + 2 x 4 rows (4 rows a step, one step of
        prefetch) and two A groups of 4 rows, 5 planes of the A window (strip
        + 2m + 2S + 1 columns and 6 for aligned copies, padded to 8 mod 32),
        two V groups of 4 rows x 5 planes (strip + 2m + 1 columns: the h
        stage's 2 outputs a thread; padded the same)."""
        g = ti.strip_geometry(b, h, w, win, S, 132)
        m = win // 2
        aw = g.strip + 2 * m + 2 * S + 1
        awp = _first_at_least(aw + 6, 8)
        vs = _first_at_least(g.strip + 2 * m + 1, 8)
        want = 4 * (5 * awp * (2 * S + 1 + 8) + 5 * awp * 8 + 5 * vs * 8)
        assert g.smem_bytes == want == ti.strip_smem_bytes(g.strip, m, S)
        assert g.smem_bytes <= _build.MAX_SMEM_BYTES

    def test_ring_bytes_of_the_main_shapes(self):
        # 752x480 b=8 S=8: 7 strips of 108: A window 137 + 6 -> 168 floats,
        # ring 25 rows, V 121 -> 136; 1920x1024 b=2 S=16: 17 strips of 113:
        # 158 + 6 -> 168, ring 41 rows, V 126 -> 136
        g = ti.strip_geometry(8, 480, 752, 12, 8, 132)
        assert g.strip == 108
        assert g.smem_bytes == 4 * 5 * (168 * (25 + 8) + 8 * 136) == 132_640
        g = ti.strip_geometry(2, 1024, 1920, 12, 16, 132)
        assert g.strip == 113
        assert g.smem_bytes == 4 * 5 * (168 * (41 + 8) + 8 * 136) == 186_400

    @pytest.mark.parametrize("b,h,w,S,win", STRIP_CASES)
    def test_every_row_once_no_wave_tail(self, b, h, w, S, win):
        g = ti.strip_geometry(b, h, w, win, S, 132)
        assert g.strips * g.strip >= w > (g.strips - 1) * g.strip
        assert g.strip + 2 * (win // 2) <= ti.STRIP_COLS
        runs = ti.strip_segments(b, h, g.strips, g.rows, g.runs_per_col)
        assert len(runs) == g.blocks <= 132
        assert sum(n for run in runs for n in run) == b * g.strips * h
        assert all(0 < n <= h for run in runs for n in run)

    @pytest.mark.parametrize("b,h,w,S,win", STRIP_CASES)
    def test_every_sm_has_work_where_the_layer_allows(self, b, h, w, S, win):
        """As many blocks as an even cut of the rows into whole runs over
        the 132 SMs gives (a block on every SM where the layer has enough
        rows), but for less than one block per strip column, the remainder
        of cutting each column evenly."""
        g = ti.strip_geometry(b, h, w, win, S, 132)
        total, cols = b * g.strips * h, b * g.strips
        assert g.blocks >= -(-total // -(-total // 132)) - cols

    @pytest.mark.parametrize("win", [12, 9])
    @pytest.mark.parametrize("S", [8, 16])
    def test_overrun_refused(self, S, win):
        """S = 8 and 16 fit at the widest strip; the first max_shift past
        227 KB is refused before any launch, the one before it taken."""
        m = win // 2
        widest = ti.STRIP_COLS - 2 * m
        assert ti.strip_launch_smem(widest, win, S) <= _build.MAX_SMEM_BYTES
        over = min(s for s in range(S, 512)
                   if ti.strip_smem_bytes(widest, m, s) > _build.MAX_SMEM_BYTES)
        ti.strip_launch_smem(widest, win, over - 1)
        with pytest.raises(ValueError, match="shared memory"):
            ti.strip_launch_smem(widest, win, over)

    @pytest.mark.parametrize("strip,win,match", [
        (117, 12, "columns"), (0, 12, "columns"), (60, 66, "winsize"), (60, 0, "winsize")])
    def test_shapes_the_kernel_does_not_take(self, strip, win, match):
        with pytest.raises(ValueError, match=match):
            ti.strip_launch_smem(strip, win, 8)


class TestFusedSchedule:
    """Which blocks farneback_iterate_fused runs a layer on: strips where
    its runs hold at least 3 x max_shift rows, else the tile design's."""

    @pytest.mark.parametrize("b,h,w,S,win", STRIP_CASES)
    def test_strips_where_the_runs_are_long_enough(self, b, h, w, S, win):
        g = ti.strip_geometry(b, h, w, win, S, 132)
        sched = ti.fused_schedule(b, h, w, win, S, 132)
        if g.rows >= 3 * S:
            assert sched == g
        else:
            assert sched == ti.tile_for(b, h, w, 132)
            ti.tiled_launch_smem(sched, win, S)

    @pytest.mark.parametrize("b,h,w,S,want", [
        (8, 480, 752, 8, "strips"), (8, 240, 376, 8, "strips"), (8, 120, 188, 8, (32, 32)),
        (2, 1024, 1920, 16, "strips"), (2, 512, 960, 16, "strips"),
        (2, 256, 480, 16, (32, 32)), (4, 1024, 1920, 16, "strips"),
        (4, 512, 960, 16, "strips"), (4, 256, 480, 16, (32, 64)),
        (1, 480, 752, 8, "strips"), (1, 240, 376, 8, (32, 32)), (1, 120, 188, 8, (32, 32)),
        (1, 1024, 1920, 16, "strips"), (1, 512, 960, 16, (32, 64)),
        (1, 256, 480, 16, (32, 32))])
    def test_the_product_layers(self, b, h, w, S, want):
        """The layers timed in chip_smoke.py phase 3, at the product's
        max_shift: every finest layer streams; the coarse ones at b = 1,
        and the coarsest at every b, take tiles."""
        sched = ti.fused_schedule(b, h, w, 12, S, 132)
        if want == "strips":
            assert isinstance(sched, ti.StripGeometry)
        else:
            assert sched == want


def _chain_update_matrices(R0, R1, flow, border, S):
    """The TPU kernel's update (farneback_pallas._iter_math) in its own
    form: sums over every shift s in [-S, S+1] of where-selected weights
    times shifted edge-padded planes."""
    b, _, H, W = R0.shape
    fx, fy, sx, sy = ti._warp_coords(flow, S)[:4]
    sx, sy = sx.float(), sy.float()
    pad = S + 1
    R1p = torch.nn.functional.pad(R1, (0, 0, pad, pad), mode="replicate")
    A = torch.zeros_like(R1)
    for s in range(-S, S + 2):
        wgt = (torch.where(sy == s, 1.0 - fy, 0.0)
               + torch.where(sy == s - 1, fy, 0.0))[:, None]
        A = A + wgt * R1p[:, :, pad + s:pad + s + H, :]
    Ap = torch.nn.functional.pad(A, (pad, pad, 0, 0), mode="replicate")
    r = torch.zeros_like(R1)
    for s in range(-S, S + 2):
        wgt = (torch.where(sx == s, 1.0 - fx, 0.0)
               + torch.where(sx == s - 1, fx, 0.0))[:, None]
        r = r + wgt * Ap[:, :, :, pad + s:pad + s + W]
    dx, dy = flow[:, 0], flow[:, 1]
    r4 = (R0[:, 2] + r[:, 2]) * 0.5
    r5 = (R0[:, 3] + r[:, 3]) * 0.5
    r6 = (R0[:, 4] + r[:, 4]) * 0.25
    r2 = (R0[:, 0] - r[:, 0]) * 0.5
    r3 = (R0[:, 1] - r[:, 1]) * 0.5
    r2 = (r2 + r4 * dy + r6 * dx) * border
    r3 = (r3 + r6 * dy + r5 * dx) * border
    r4, r5, r6 = r4 * border, r5 * border, r6 * border
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=1)


class TestSolver:
    def test_flow_batch_matches_jax_tuned(self):
        """The port's whole solver (tuned params, CPU) vs the JAX product
        path with tuned_flow_params (Pallas interpret mode): 48x64, b=2."""
        prev, curr = _frames(2, 48, 64, seed=5)
        ref = np.asarray(jf.farneback_flow_batch(
            jnp.asarray(prev), jnp.asarray(curr), jf.tuned_flow_params(48, 64)))
        got = tf.farneback_flow_batch(prev, curr, device="cpu")
        assert got.device.type == "cpu" and got.shape == (2, 48, 64, 2)
        assert np.abs(got.numpy() - ref).max() < 1e-3

    def test_single_pair_is_batch_of_one(self):
        prev, curr = _frames(2, 40, 48, seed=6)
        one = tf.farneback_flow(prev[1], curr[1], device="cpu")
        both = tf.farneback_flow_batch(prev, curr, device="cpu")
        np.testing.assert_allclose(one.numpy(), both[1].numpy(), atol=1e-5)

    def test_epe_vs_cv2_oracle(self):
        """cv2's Farneback at the reference's spec (pyr 0.4, 1 level, win
        12, 10 iterations, poly 8/1.2) on a 96x128 scene: mean EPE < 0.1 px,
        the JAX package's own gate for its kernel."""
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(0)
        base = cv2.GaussianBlur(rng.random((96, 128)).astype(np.float32), (0, 0), 1.5) * 255
        curr = cv2.warpAffine(base, np.float32([[1, 0, 2.4], [0, 1, 1.6]]), (128, 96))
        p8, c8 = base.astype(np.uint8), curr.astype(np.uint8)
        ref = cv2.calcOpticalFlowFarneback(p8, c8, None, 0.4, 1, 12, 10, 8, 1.2, 0)
        got = tf.farneback_flow(p8, c8, tf.FarnebackParams(iterations=10),
                                device="cpu").numpy()
        assert np.linalg.norm(got - ref, axis=-1).mean() < 0.1


def test_scene_render_matches_reference_family():
    """The scipy render keeps bench.make_scene's GT flow formula exactly and
    its frames within the render's interpolation differences."""
    cv2 = pytest.importorskip("cv2")
    del cv2
    import bench
    from mav_detection_tpu_torch.data.scene import make_scene

    p_ref, c_ref, gt_ref = bench.make_scene(0, h=96, w=160, foe=(60.0, 40.0))
    p, c, gt = make_scene(0, h=96, w=160, foe=(60.0, 40.0))
    np.testing.assert_allclose(gt, gt_ref, atol=1e-5)
    assert np.abs(p.astype(float) - p_ref).mean() < 2.0
    assert np.abs(c.astype(float) - c_ref).mean() < 2.0


def test_scene_epe_within_chip_gate_on_cpu():
    """The scipy render at 752x480 through the plain path stays inside the
    EPE-vs-GT gate that chip_smoke.py holds the card to (< 0.40 px on the
    16-px interior; the reference reached 0.333 px on its OpenCV render)."""
    from mav_detection_tpu_torch.data.scene import epe_interior, make_scene

    prev, curr, gt = make_scene(0)
    flow = tf.farneback_flow(prev, curr, device="cpu").numpy()
    assert epe_interior(flow, gt) < 0.40

"""The port's tensor-code Farneback solvers (``update_matrices``,
``solve_flow``, ``jacobi_level`` and the level loop's dispatch on ``warp``)
held to the JAX package's XLA path on the CPU, and the ``entry()`` analogue.

The reference's arrays are (h, w, b, c), the port's (b, c, H, W): the tests
transpose. Inputs are made with numpy from a seed and fed to both packages.

Tolerances, with their reasons:
* ``update_matrices``, per warp: 1e-5 of M's scale (elementwise fp32; XLA on
  the CPU contracts a*b + c into fused multiply-adds, the port rounds each
  op). The reference's separable warp sums 2S+2 shifted planes of which two
  carry weight; the port gathers those two, which is exact.
* ``solve_flow``: 1e-4 px (box sums as matmuls, in whatever order each
  library's matmul takes them).
* ``jacobi_level``: 1e-4 px over its iterations.
* ``jacobi_level`` with ``fast`` off vs the fused iteration's plain version:
  1e-4 px over 3 iterations (matmul box sums vs shifted sums).
* a whole ``farneback_flow``: 1e-3 px (the reference's batch-1 path runs
  unfused preprocessing, the port the fused matrices).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.ndimage import gaussian_filter, shift as nd_shift

from mav_detection_tpu.ops.flow import farneback as jf

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.entry import ENTRY_FOE_SAMPLES, ENTRY_SHAPE, entry
from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.flow import farneback_iter as ti
from mav_detection_tpu_torch.pipeline.detector import DetectionStep, detect_frame_pair

# Tiny shapes: one intra-op thread, so that test workers running side by side
# do not oversubscribe the cores (thousands of small ops, each a thread barrier).
torch.set_num_threads(1)

S = 8


def _frames(b, h, w, seed=0, motion=((1.3, 2.1), (-0.8, 1.6), (2.5, -1.2))):
    rng = np.random.default_rng(seed)
    prev = np.stack([gaussian_filter(rng.random((h, w)), 1.5) for _ in range(b)])
    prev = ((prev - prev.min()) / np.ptp(prev) * 220 + 20).astype(np.float32)
    curr = np.stack([nd_shift(prev[i], motion[i % len(motion)], order=1,
                              mode="nearest") for i in range(b)])
    return prev, curr.astype(np.float32)


def _level_inputs(b, h, w, seed=0, peak=4.0):
    """(R0, R1, flow, border) numpy, channel-first, from the JAX functions;
    ``peak`` is the flow's largest magnitude in px."""
    prev, curr = _frames(b, h, w, seed)
    smooth = jf._gaussian_kernel(3, 0.0)
    R0 = np.asarray(jf._poly_exp_pyr_cf(jnp.asarray(prev), smooth, h, w, 8, 1.2))
    R1 = np.asarray(jf._poly_exp_pyr_cf(jnp.asarray(curr), smooth, h, w, 8, 1.2))
    rng = np.random.default_rng(seed + 100)
    flow = gaussian_filter(rng.standard_normal((b, 2, h, w)), (0, 0, 3, 3))
    flow = (flow / np.abs(flow).max() * peak).astype(np.float32)
    return R0, R1, flow, np.asarray(jf._border_scale_map(h, w))


def _hwbc(x):
    """(b, c, H, W) numpy -> the reference's (h, w, b, c) array."""
    return jnp.transpose(jnp.asarray(x), (2, 3, 0, 1))


def _bchw(x):
    return np.transpose(np.asarray(x), (2, 3, 0, 1))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


class TestUpdateMatrices:
    @pytest.mark.parametrize("warp", ["gather", "separable", "auto"])
    @pytest.mark.parametrize("peak", [4.0, 12.5])
    def test_matches_jax(self, warp, peak):
        """Each warp, with the flow inside +-(S-1) and beyond it: ``auto``
        takes its separable branch on the first and its gather branch on the
        second."""
        R0, R1, flow, border = _level_inputs(2, 40, 56, seed=1, peak=peak)
        ref = _bchw(jf._update_matrices(_hwbc(R0), _hwbc(R1), _hwbc(flow),
                                        jnp.asarray(border), warp, S))
        got = tf.update_matrices(*_t(R0, R1, flow, border), warp, S).numpy()
        assert got.shape == ref.shape == (2, 5, 40, 56)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    @pytest.mark.parametrize("peak,branch", [(4.0, "separable"), (12.5, "gather")])
    def test_auto_selects_by_the_largest_displacement(self, peak, branch):
        args = _t(*_level_inputs(2, 40, 56, seed=2, peak=peak))
        auto = tf.update_matrices(*args, "auto", S)
        assert torch.equal(auto, tf.update_matrices(*args, branch, S))
        other = "gather" if branch == "separable" else "separable"
        assert not torch.equal(auto, tf.update_matrices(*args, other, S))

    def test_separable_is_the_fused_iterations_update(self):
        args = _t(*_level_inputs(2, 23, 31, seed=3, peak=11.0))
        assert torch.equal(tf.update_matrices(*args, "separable", S),
                           ti.update_matrices_ref(*args, S))

    @pytest.mark.parametrize("warp", ["gather", "separable", "auto"])
    def test_row_slab_with_global_rows_equals_the_whole_image(self, warp):
        """A haloed row slab given its first global row and the image's
        height gives, on its inner rows, the same M as the whole image: the
        inside gate tests global rows, and the warp reads no further than
        the halo (S + 1 rows). Not bit-equal: the fraction of row + dy is
        rounded at the row number's size, which is the slab's own (1e-5 of
        M's scale, as the reference's slab)."""
        H, W, r0, r1, halo = 64, 48, 24, 40, S + 2
        R0, R1, flow, border = _level_inputs(1, H, W, seed=4, peak=6.0)
        whole = tf.update_matrices(*_t(R0, R1, flow, border), warp, S)
        lo, hi = r0 - halo, r1 + halo
        slab = tf.update_matrices(
            *_t(R0[:, :, lo:hi], R1[:, :, lo:hi], flow[:, :, lo:hi], border[lo:hi]),
            warp, S, row0=lo, global_h=H)
        inner = (slab[:, :, halo:-halo] - whole[:, :, r0:r1]).abs().max()
        assert inner <= 1e-5 * whole.abs().max()
        # and against the reference's slab
        ref = _bchw(jf._update_matrices(
            _hwbc(R0[:, :, lo:hi]), _hwbc(R1[:, :, lo:hi]), _hwbc(flow[:, :, lo:hi]),
            jnp.asarray(border[lo:hi]), warp, S, row0=lo, global_h=H))
        assert np.abs(slab.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()

    def test_slab_at_the_image_top_needs_the_global_gate(self):
        """Without row0 a slab's last rows count as the image's edge: the
        fractions there are zeroed, and M differs from the whole image's."""
        H, W = 64, 48
        R0, R1, flow, border = _level_inputs(1, H, W, seed=5, peak=6.0)
        flow[:, 1] = np.abs(flow[:, 1]) + 0.5      # every pixel looks down
        whole = tf.update_matrices(*_t(R0, R1, flow, border), "gather", S)
        cut = [a[:, :, :32] for a in (R0, R1, flow)] + [border[:32]]
        gated = tf.update_matrices(*_t(*cut), "gather", S, row0=0, global_h=H)
        local = tf.update_matrices(*_t(*cut), "gather", S)
        assert torch.equal(gated[:, :, :16], whole[:, :, :16])
        # the last slab row: local gating zeroes its fractions, global keeps them
        assert not torch.equal(gated[:, :, 31], local[:, :, 31])

    def test_unknown_warp_refused(self):
        args = _t(*_level_inputs(1, 20, 24, seed=6))
        with pytest.raises(ValueError, match="warp"):
            tf.update_matrices(*args, "fused", S)


class TestSolveFlow:
    @pytest.mark.parametrize("winsize", [12, 5, 4])
    def test_matches_jax(self, winsize):
        """winsize 12 (the product's) and an odd/even pair: an even window
        sums 2*(winsize//2)+1 taps and still divides by winsize**2."""
        R0, R1, flow, border = _level_inputs(2, 40, 56, seed=7)
        M = np.asarray(tf.update_matrices(*_t(R0, R1, flow, border), "separable", S))
        ref = _bchw(jf._solve_flow(_hwbc(M), winsize))
        got = tf.solve_flow(torch.from_numpy(M), winsize).numpy()
        assert got.shape == ref.shape == (2, 2, 40, 56)
        assert np.abs(got - ref).max() < 1e-4

    @pytest.mark.parametrize("winsize", [12, 5, 4])
    def test_matmul_box_equals_shifted_sums(self, winsize):
        """The band-matmul window sum against the fused iteration's shifted
        sums (``box_solve_ref``): the same function in another sum order."""
        M = tf.update_matrices(*_t(*_level_inputs(2, 33, 47, seed=8)), "separable", S)
        assert (tf.solve_flow(M, winsize) - ti.box_solve_ref(M, winsize)).abs().max() < 1e-4

    def test_even_window_sums_one_extra_tap(self):
        ones = torch.ones((1, 1, 20, 20))
        assert tf._box_blur(ones, 4)[0, 0, 10, 10] == 25.0
        assert tf._box_blur(ones, 5)[0, 0, 10, 10] == 25.0


class TestJacobiLevel:
    @pytest.mark.parametrize("fast", [False, True])
    @pytest.mark.parametrize("warp", ["separable", "auto"])
    def test_matches_jax(self, fast, warp):
        R0, R1, flow, border = _level_inputs(2, 40, 56, seed=9)
        kw = dict(warp=warp, fast=fast, max_shift=S, iterations=7)
        ref = _bchw(jf._jacobi_level(_hwbc(R0), _hwbc(R1), _hwbc(flow),
                                     jnp.asarray(border), jf.FarnebackParams(**kw)))
        got = tf.jacobi_level(*_t(R0, R1, flow, border), tf.FarnebackParams(**kw)).numpy()
        assert np.abs(got - ref).max() < 1e-4

    @pytest.mark.parametrize("n,fast,expected", [
        (10, True, {0, 1, 2, 4, 7}), (6, True, {0, 1, 2, 4}), (3, True, {0, 1}),
        (1, True, set()), (4, False, {0, 1, 2}), (1, False, set())])
    def test_refit_schedule(self, n, fast, expected):
        p = tf.FarnebackParams(fast=fast, iterations=n)
        assert tf._refit_schedule(p) == expected
        assert tf._refit_schedule(p, n) == jf._refit_schedule(
            jf.FarnebackParams(fast=fast, iterations=n), n)

    def test_every_refit_schedule_is_the_fused_iterations_sequence(self):
        """The fused iteration refits before every solve; ``jacobi_level``
        with ``fast`` off refits before the first and after all but the
        last: the same sequence. 3 iterations, within 1e-4 px."""
        args = _t(*_level_inputs(2, 40, 56, seed=10))
        p = tf.FarnebackParams(warp="separable", max_shift=S)
        a = tf.jacobi_level(*args, p, iterations=3)
        b = ti.farneback_iterate_ref(*args, 3, p.winsize, S)
        assert (a - b).abs().max() < 1e-4

    def test_fast_refits_fewer_times(self, monkeypatch):
        calls = []
        real = tf.update_matrices
        monkeypatch.setattr(tf, "update_matrices",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        args = _t(*_level_inputs(1, 24, 32, seed=11))
        tf.jacobi_level(*args, tf.FarnebackParams(warp="separable", fast=True))
        assert len(calls) == 1 + 5
        calls.clear()
        tf.jacobi_level(*args, tf.FarnebackParams(warp="separable"))
        assert len(calls) == 1 + 9


class TestLevelLoop:
    @pytest.mark.parametrize("kw", [
        dict(warp="separable", fast=True, max_shift=8),
        dict(warp="auto", fast=True, levels=2, pyr_scale=0.5),
        dict(warp="gather")],
        ids=["separable-fast", "auto-fast-pyramid", "gather"])
    def test_flow_matches_jax(self, kw):
        prev, curr = _frames(1, 96, 128, seed=12)
        ref = np.asarray(jf.farneback_flow(jnp.asarray(prev[0]), jnp.asarray(curr[0]),
                                           jf.FarnebackParams(**kw)))
        got = tf.farneback_flow(prev[0], curr[0], tf.FarnebackParams(**kw),
                                device="cpu").numpy()
        assert got.shape == ref.shape == (96, 128, 2)
        assert np.abs(got - ref).max() < 1e-3
        assert np.abs(ref).max() > 1.0

    def test_batch_matches_jax(self):
        kw = dict(warp="auto", fast=True, levels=2, pyr_scale=0.5)
        prev, curr = _frames(2, 48, 64, seed=13)
        ref = np.asarray(jf.farneback_flow_batch(jnp.asarray(prev), jnp.asarray(curr),
                                                 jf.FarnebackParams(**kw)))
        got = tf.farneback_flow_batch(prev, curr, tf.FarnebackParams(**kw),
                                      device="cpu").numpy()
        assert np.abs(got - ref).max() < 1e-3

    def test_dispatch_on_warp(self, monkeypatch):
        """``fused`` goes through ``farneback_iterate``, every other warp
        through ``jacobi_level``, once per pyramid layer."""
        seen = []
        real_it, real_jl = tf.farneback_iterate, tf.jacobi_level
        monkeypatch.setattr(tf, "farneback_iterate",
                            lambda *a, **k: seen.append("fused") or real_it(*a, **k))
        monkeypatch.setattr(tf, "jacobi_level",
                            lambda *a, **k: seen.append("jacobi") or real_jl(*a, **k))
        prev, curr = _frames(1, 48, 64, seed=14)
        tf.farneback_flow(prev[0], curr[0], device="cpu")       # tuned: fused
        assert seen == ["fused"] * 2      # 48 rows: two layers fit the poly window
        seen.clear()
        tf.farneback_flow(prev[0], curr[0], tf.FarnebackParams(
            warp="separable", levels=1, iterations=2), device="cpu")
        assert seen == ["jacobi"] * 2

    def test_unknown_warp_refused(self):
        prev, curr = _frames(1, 40, 48, seed=15)
        with pytest.raises(ValueError, match="warp='pallas' is not valid"):
            tf.farneback_flow(prev[0], curr[0], tf.FarnebackParams(warp="pallas"),
                              device="cpu")

    @pytest.mark.parametrize("h,w", [(480, 752), (1024, 1920), (240, 320)])
    def test_tuned_params_select_the_fused_kernel(self, h, w):
        p = tf.tuned_flow_params(h, w)
        assert p.warp == "fused" and p.level_iters == (2, 3, 8) and not p.fast

    def test_defaults_are_the_references(self):
        j, t = jf.FarnebackParams(), tf.FarnebackParams()
        for name in tf.FarnebackParams.__dataclass_fields__:
            assert getattr(t, name) == getattr(j, name), name


class TestConvertWarps:
    @pytest.mark.parametrize("kw,warp", [
        (dict(warp="gather"), "gather"), (dict(warp="auto", fast=True), "auto"),
        (dict(warp="separable", fast=True, max_shift=8), "separable"),
        (dict(warp="separable"), "separable"), (dict(warp="pallas", band_rows=24), "fused"),
        (dict(), "gather")])
    def test_warp_and_fast_carry_over(self, kw, warp):
        jp = jf.FarnebackParams(**kw)
        tp = convert.farneback_params_from_reference(dataclasses.asdict(jp))
        assert tp.warp == warp and tp.fast == jp.fast
        assert (tp.max_shift, tp.levels, tp.iterations) == (jp.max_shift, jp.levels,
                                                            jp.iterations)

    def test_unknown_field_refused(self):
        with pytest.raises(ValueError, match="unknown"):
            convert.farneback_params_from_reference({"warp": "gather", "tile": 3})


class TestEntry:
    def test_runs_on_the_cpu_and_equals_its_pieces(self):
        """``fn(*example_args)``: finite outputs of the stated shapes, equal
        to the port's own ``farneback_flow`` + ``detect_frame_pair`` on the
        same arguments (each piece is held to the reference elsewhere; the
        reference's ``entry()`` hard-codes other flow parameters off the
        TPU)."""
        fn, args = entry("cpu")
        h, w = ENTRY_SHAPE
        assert len(args) == 9 and all(a.device.type == "cpu" for a in args)
        assert args[0].shape == args[1].shape == (h, w)
        assert args[-1].shape == (2 * ENTRY_FOE_SAMPLES, 2)
        assert int(args[-1][:, 0].max()) < h and int(args[-1][:, 1].max()) < w
        foe, tpr_fixed, fpr_fixed, total_mask = fn(*args)
        assert foe.shape == (2,) and total_mask.shape == (h, w)
        assert total_mask.dtype == torch.bool
        assert all(bool(torch.isfinite(x).all()) for x in (foe, tpr_fixed, fpr_fixed))
        flow = tf.farneback_flow(args[0], args[1], tf.tuned_flow_params(h, w),
                                 device="cpu")
        out = detect_frame_pair(flow, torch.zeros_like(flow), *args[2:],
                                config=DetectionStep(foe_samples=ENTRY_FOE_SAMPLES))
        assert torch.equal(foe, out.foe) and torch.equal(total_mask, out.total_mask)
        assert torch.equal(tpr_fixed, out.tpr_fixed)
        assert torch.equal(fpr_fixed, out.fpr_fixed)

    def test_example_arguments_are_the_references(self):
        """The same seeded numpy draws as the reference's ``entry()``."""
        import __graft_entry__

        _, ref = __graft_entry__.entry()
        _, got = entry("cpu")
        for k in range(8):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), str(k))

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the no-card path cannot be shown")
        with pytest.raises(RuntimeError, match="cuda"):
            entry()

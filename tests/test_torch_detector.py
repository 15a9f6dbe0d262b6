"""The port's batched detection step held to the JAX package's, field by
field, for the same flow and the same FoE samples.

JAX draws its FoE samples inside the step from a key; the test rebuilds that
draw per frame (``split(key)`` then ``randint`` on each half, as
``get_foe_dense`` does) and hands the indices to the port.

Tolerances: counts and rates exact to float32 rounding (atol 1e-6); FoE and
flow means within rtol 1e-5 (XLA on the CPU contracts the line-intersection
determinants into fused multiply-adds, the port rounds each op); angles
within 1e-4 degrees for arctan2 and 0.05 degrees for the phi map (arccos
near +-1 turns one ulp of its argument into ~0.02 degrees).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.ops.geometry import derotation as jderot
from mav_detection_tpu.ops.geometry import foe as jfoe
from mav_detection_tpu.ops.image import boxes as jboxes
from mav_detection_tpu.ops.image import metrics as jmetrics
from mav_detection_tpu.pipeline import detector as jdet
from mav_detection_tpu.pipeline.processor import _pack_frame_scalars

from mav_detection_tpu_torch.ops.geometry import derotation as tderot
from mav_detection_tpu_torch.ops.geometry import foe as tfoe
from mav_detection_tpu_torch.ops.image import boxes as tboxes
from mav_detection_tpu_torch.ops.image import metrics as tmetrics
from mav_detection_tpu_torch.pipeline import detector as tdet


@pytest.fixture
def rng():
    """A generator of this test's own. The repository-wide ``rng`` fixture is
    one stream for the whole test run: drawing from it here would shift the
    numbers that the JAX package's tests draw after this file in the same
    worker process."""
    return np.random.default_rng(1234)


def jax_samples(keys, n_samples: int, h: int, w: int) -> np.ndarray:
    """(n, 2N, 2) (y, x) indices JAX's get_foe_dense draws from ``keys``."""
    out = []
    for k in keys:
        ky, kx = jax.random.split(k)
        out.append(np.stack([
            np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
            np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
    return np.stack(out)


def make_batch(n=3, h=40, w=56, seed=0, foe=(30.0, 18.0), empty_seg=(),
               nan_foe=()):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flows, segs = [], []
    for i in range(n):
        f = 0.12 * np.stack([xs - foe[0], ys - foe[1]], -1)
        f += rng.standard_normal(f.shape).astype(np.float32) * 0.3
        cx, cy = 10 + 3 * i, 12 + i
        disc = (xs - cx) ** 2 + (ys - cy) ** 2 <= 16
        f[disc] = (3.0, -2.0)
        flows.append(f)
        segs.append(np.where(disc & (i not in empty_seg), 255, 0).astype(np.uint8))
    flow = np.stack(flows).astype(np.float32)
    gt_flow = (flow + rng.standard_normal(flow.shape).astype(np.float32) * 0.1)
    omega = (rng.standard_normal((n, 3)) * 0.05).astype(np.float32)
    dt = np.full((n,), 0.05, np.float32)
    sky = np.zeros((n, h, w), bool)
    sky[:, :8] = True
    sky[:, 8:10] = rng.random((n, 2, w)) > 0.5
    depth = np.where(np.arange(h)[:, None] < 9, 100.0, 20.0).astype(np.float32)
    depth = np.broadcast_to(depth, (n, h, w)).copy()
    gt_foe = np.tile(np.float32(foe), (n, 1))
    for i in nan_foe:
        gt_foe[i] = np.nan
    return [flow, gt_flow, omega, dt, np.stack(segs), sky, depth, gt_foe]


def run_both(args, n_samples=300, key=0):
    n, h, w = args[0].shape[:3]
    keys = jax.random.split(jax.random.PRNGKey(key), n)
    ref = jdet.detect_frame_batch_scalars(
        *(jnp.asarray(a) for a in args), keys,
        jdet.DetectionStep(foe_samples=n_samples))
    syx = torch.from_numpy(jax_samples(keys, n_samples, h, w))
    got = tdet.detect_frame_batch_scalars(
        *(torch.from_numpy(np.asarray(a)) for a in args), sample_yx=syx,
        config=tdet.DetectionStep(foe_samples=n_samples))
    return ref, got


def assert_scalars_match(ref, got):
    assert ref._fields == got._fields
    for name in ref._fields:
        r = np.asarray(getattr(ref, name), np.float64)
        g = getattr(got, name).numpy().astype(np.float64)
        assert r.shape == g.shape, name
        if name in ("foe", "drone_flow_pixels"):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
        elif name == "center_phi":
            np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed,key", [(0, 0), (1, 7), (2, 3)])
def test_frame_scalars_match_jax(seed, key):
    ref, got = run_both(make_batch(seed=seed), key=key)
    assert_scalars_match(ref, got)
    assert np.isfinite(got.foe.numpy()).all()
    assert (got.tpr_fixed.numpy() > 0).any()


def test_empty_segmentation_gives_nan_tpr():
    ref, got = run_both(make_batch(empty_seg=(1,)))
    assert_scalars_match(ref, got)
    assert math.isnan(float(got.tpr[1])) and math.isnan(float(got.tpr_fixed[1]))
    assert np.isnan(got.drone_flow_pixels[1].numpy()).all()
    assert not math.isnan(float(got.tpr[0]))


def test_nan_gt_foe_gives_nan_center_phi():
    ref, got = run_both(make_batch(nan_foe=(2,)))
    assert_scalars_match(ref, got)
    assert math.isnan(float(got.center_phi[2]))


def test_all_parallel_lines_give_zero_foe():
    """A uniform translation: every line pair is parallel, no candidate is
    valid, the FoE is (0, 0) as upstream's optimum = 0 initialization."""
    args = make_batch(n=2)
    args[0] = np.broadcast_to(np.float32([3.0, -1.0]), args[0].shape).copy()
    args[2] = np.zeros_like(args[2])          # no derotation: stay parallel
    ref, got = run_both(args)
    assert_scalars_match(ref, got)
    np.testing.assert_array_equal(got.foe.numpy(), 0.0)


def test_tied_votes_pick_the_first_maximum():
    est = np.float32([[[0, 0], [100, 100], [5, 0], [105, 100], [300, 300]],
                      [[1, 1], [200, 5], [2, 200], [201, 6], [202, 7]]])
    valid = np.array([[True, True, True, True, True],
                      [True, True, False, True, True]])
    ref = np.stack([np.asarray(jfoe.foe_ransac(jnp.asarray(e), jnp.asarray(v)))
                    for e, v in zip(est, valid)])
    got = tfoe.foe_ransac(torch.from_numpy(est), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], [0, 0])       # index 0 ties index 1
    np.testing.assert_array_equal(got[1], [200, 5])     # 2 inliers beat 1


def test_line_intersections_match(rng):
    p1, d1, p2, d2 = (rng.standard_normal((200, 2)).astype(np.float32) * 20
                      for _ in range(4))
    # parallel rows on small integers, where every product is exact: with
    # rounded products XLA's fused multiply-add can leave a tiny non-zero
    # determinant that the port's separately rounded ops do not
    p1[:5] = np.float32([[3, 4], [0, 0], [-7, 2], [10, 1], [5, 5]])
    p2[:5] = np.float32([[1, 9], [4, 4], [2, -3], [0, 0], [8, 1]])
    d1[:5] = np.float32([[2, 3], [1, 0], [0, 5], [-3, 2], [4, 4]])
    d2[:5] = d1[:5] * 2.0
    rp, rv = jfoe.line_intersections(*(jnp.asarray(a) for a in (p1, d1, p2, d2)))
    gp, gv = tfoe.line_intersections(*(torch.from_numpy(a) for a in (p1, d1, p2, d2)))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert not gv[:5].any()
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=1e-4, atol=1e-3)


def test_derotation_and_phi_match(rng):
    args = make_batch(n=2, seed=4)
    flow, omega, dt = args[0], args[2], args[3]
    ref = np.stack([np.asarray(jderot.derotate(jnp.asarray(flow[i]), jnp.asarray(omega[i]),
                                               jnp.asarray(dt[i]))) for i in range(2)])
    got = tderot.derotate(*(torch.from_numpy(a) for a in (flow, omega, dt))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    foe = np.float32([[30.0, 18.0], [-5.0, 60.0]])
    rphi = np.stack([np.asarray(jfoe.get_phi(jnp.asarray(ref[i]), jnp.asarray(foe[i])))
                     for i in range(2)])
    gphi = tfoe.get_phi(torch.from_numpy(ref), torch.from_numpy(foe)).numpy()
    # arccos near +-1: one ulp of its argument moves the angle ~0.02 deg
    np.testing.assert_allclose(gphi, rphi, atol=0.05)
    assert np.abs(gphi - rphi).mean() < 1e-4


def test_metrics_and_box_match(rng):
    gt = (rng.random((3, 20, 30)) > 0.7).astype(np.uint8) * 255
    est = (rng.random((3, 20, 30)) > 0.5).astype(np.int32) * 255
    gt[2] = 0
    for i in range(3):
        rt, rf = jmetrics._tpr_fpr(jnp.asarray(gt[i]), jnp.asarray(est[i]))
        tt, tf_ = tmetrics._tpr_fpr(torch.from_numpy(gt), torch.from_numpy(est))
        np.testing.assert_array_equal([float(tt[i]), float(tf_[i])],
                                      [float(rt), float(rf)])
    w = np.float32([1, 0, 1])
    np.testing.assert_array_equal(
        tmetrics.tpr_fpr_counts(*(torch.from_numpy(a) for a in (gt, est, w))).numpy(),
        np.asarray(jmetrics.tpr_fpr_counts(*(jnp.asarray(a) for a in (gt, est, w)))))
    seg = np.zeros((3, 20, 30), np.uint8)
    seg[0, 3:7, 10:15] = 255
    seg[1, 0, 29] = 30
    ref = np.stack([np.asarray(jboxes.get_simple_bounding_box_device(jnp.asarray(s)))
                    for s in seg])
    got = tboxes.get_simple_bounding_box_device(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[2], [-1, -1, -1, -1])


def test_pack_and_single_pair_match():
    args = make_batch(n=2, seed=5)
    ref, got = run_both(args)
    packed_ref = np.asarray(_pack_frame_scalars(
        ref.foe, ref.tpr, ref.fpr, ref.tpr_fixed, ref.fpr_fixed, ref.sky_tpr,
        ref.sky_fpr, ref.drone_size_pixels, ref.drone_flow_pixels,
        ref.center_phi))
    packed = tdet.pack_frame_scalars(got).numpy()
    assert packed.shape == (2, 12) and packed.dtype == np.float32
    np.testing.assert_allclose(packed, packed_ref, rtol=1e-5, atol=1e-4)
    syx = jax_samples(jax.random.split(jax.random.PRNGKey(0), 2), 300, 40, 56)
    one = tdet.detect_frame_pair(
        *(torch.as_tensor(np.asarray(a)[1]) for a in args),
        torch.from_numpy(syx[1]), config=tdet.DetectionStep(foe_samples=300))
    np.testing.assert_array_equal(one.foe.numpy(), got.foe[1].numpy())
    assert one.phi.shape == (40, 56)


def test_generator_draw_is_seeded():
    args = [torch.from_numpy(np.asarray(a)) for a in make_batch(n=2)]
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append(tdet.detect_frame_batch_scalars(
            *args, generator=g, config=tdet.DetectionStep(foe_samples=200)).foe)
    assert torch.equal(outs[0], outs[1])

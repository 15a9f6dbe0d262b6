"""The port's warps and global-motion fields held to the JAX package's on the
same seeded numpy inputs (CPU, float32): 1e-5 throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mav_detection_tpu.ops.geometry import global_motion as jgm
from mav_detection_tpu.ops.geometry import warp as jwarp

from mav_detection_tpu_torch.ops.geometry import global_motion as tgm
from mav_detection_tpu_torch.ops.geometry import warp as twarp

RNG = np.random.default_rng(11)
H, W = 40, 56
IMG = RNG.random((H, W)).astype(np.float32)
IMG2 = RNG.normal(size=(H, W, 2)).astype(np.float32)
AFFINE = np.array([[1.02, 0.03, -1.5], [-0.02, 0.98, 2.25]], np.float32)
HOMOG = np.array([[1.01, 0.02, -2.0], [-0.015, 0.99, 1.5],
                  [1e-4, -2e-4, 1.0]], np.float32)


def _maps():
    """Sample points all over, including ones that straddle each edge, lie
    exactly on it, and lie fully outside."""
    mx = RNG.uniform(-2.5, W + 1.5, (H, W)).astype(np.float32)
    my = RNG.uniform(-2.5, H + 1.5, (H, W)).astype(np.float32)
    mx[0, :6] = [-1.0, -0.5, 0.0, W - 1.0, W - 0.5, W]
    my[0, :6] = [-0.25, 0.0, H - 1.0, H - 0.75, H - 0.5, H + 3.0]
    return mx, my


@pytest.mark.parametrize("img", [IMG, IMG2], ids=["hw", "hwc"])
def test_remap_bilinear_edges(img):
    mx, my = _maps()
    ref = np.asarray(jwarp.remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                          jnp.asarray(my)))
    got = twarp.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx),
                               torch.from_numpy(my)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # per-tap zero border: a sample half outside keeps half its value
    half = twarp.remap_bilinear(torch.ones(4, 4), torch.tensor([[-0.5]]),
                                torch.tensor([[1.0]]))
    assert float(half) == pytest.approx(0.5)


@pytest.mark.parametrize("img", [IMG, IMG2], ids=["hw", "hwc"])
def test_sample_bilinear_replicate(img):
    mx, my = _maps()
    ref = np.asarray(jwarp.sample_bilinear_replicate(
        jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    got = twarp.sample_bilinear_replicate(
        torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("out_hw", [None, (30, 70)])
def test_warp_affine_perspective(out_hw):
    for jf, tf, M in ((jwarp.warp_affine, twarp.warp_affine, AFFINE),
                      (jwarp.warp_perspective, twarp.warp_perspective, HOMOG)):
        ref = np.asarray(jf(jnp.asarray(IMG2), jnp.asarray(M), out_hw))
        got = tf(torch.from_numpy(IMG2), torch.from_numpy(M), out_hw).numpy()
        assert got.shape == ref.shape
        # the inverse matrix differs at fp32 rounding, scaled by ~W px
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_motion_fields():
    ref = np.asarray(jgm.affine_motion_field(jnp.asarray(AFFINE), H, W))
    got = tgm.affine_motion_field(torch.from_numpy(AFFINE), H, W).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    for projective in (False, True):
        ref = np.asarray(jgm.homography_motion_field(
            jnp.asarray(HOMOG), H, W, projective))
        got = tgm.homography_motion_field(
            torch.from_numpy(HOMOG), H, W, projective).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_subtract_global_motion():
    gm = np.asarray(jgm.homography_motion_field(jnp.asarray(HOMOG), H, W))
    r_res, r_mag = jgm.subtract_global_motion(jnp.asarray(IMG2), jnp.asarray(gm))
    g_res, g_mag = tgm.subtract_global_motion(torch.from_numpy(IMG2),
                                              torch.from_numpy(gm))
    np.testing.assert_allclose(g_res.numpy(), np.asarray(r_res), atol=1e-6)
    np.testing.assert_allclose(g_mag.numpy(), np.asarray(r_mag), atol=1e-5)


@pytest.mark.parametrize("homography", [False, True])
def test_warp_diff_method(homography):
    M = HOMOG if homography else AFFINE
    r_diff, r_mag = jgm.warp_diff_method(jnp.asarray(IMG2), jnp.asarray(M),
                                         homography)
    g_diff, g_mag = tgm.warp_diff_method(torch.from_numpy(IMG2),
                                         torch.from_numpy(M), homography)
    np.testing.assert_allclose(g_diff.numpy(), np.asarray(r_diff), atol=2e-4)
    np.testing.assert_allclose(g_mag.numpy(), np.asarray(r_mag), atol=2e-4)
    # the zero mask is per channel: where the warp left a zero, the
    # difference is zero in that channel
    ident = torch.tensor([[1.0, 0, 0], [0, 1, 0]])
    diff, _ = tgm.warp_diff_method(torch.ones(8, 9, 2), ident)
    assert float(diff.abs().max()) < 1e-5

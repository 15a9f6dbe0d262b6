"""The port's RANSAC fits held to the JAX package's with JAX's minimal-set
draw fed in (``idx``). Null vectors of an SVD carry an arbitrary sign and
LAPACK orders near-equal singular values by its own rule, so models are
compared by what they do (reprojection, Sampson distance, motion field) and
F / E up to sign."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.ops.geometry import global_motion as jgm
from mav_detection_tpu.ops.geometry import ransac_fits as jr

from mav_detection_tpu_torch.ops.geometry import global_motion as tgm
from mav_detection_tpu_torch.ops.geometry import ransac_fits as tr

N = 400
H, W = 120, 160


def _scene(seed, model):
    """Correspondences of a known model plus 0.2 px noise and 20 % gross
    outliers."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform([10, 10], [W - 10, H - 10], (N, 2)).astype(np.float32)
    if model == "affine":
        M = np.array([[1.01, 0.02, 1.5], [-0.02, 0.99, -2.0]])
        p1 = p0 @ M[:, :2].T + M[:, 2]
    elif model == "homography":
        Hm = np.array([[1.01, 0.02, 1.5], [-0.02, 0.99, -2.0], [1e-4, -5e-5, 1.0]])
        q = np.concatenate([p0, np.ones((N, 1))], 1) @ Hm.T
        p1 = q[:, :2] / q[:, 2:]
    else:  # a rigid camera motion over points at random depth
        z = rng.uniform(4.0, 12.0, N)
        f = 100.0
        X = np.stack([(p0[:, 0] - W / 2) * z / f, (p0[:, 1] - H / 2) * z / f, z], 1)
        a = 0.03
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        X1 = X @ R.T + np.array([0.3, -0.1, 0.2])
        p1 = np.stack([X1[:, 0] / X1[:, 2] * f + W / 2,
                       X1[:, 1] / X1[:, 2] * f + H / 2], 1)
    p1 = p1 + rng.normal(scale=0.2, size=p1.shape)
    out = rng.random(N) < 0.2
    p1[out] += rng.uniform(-25, 25, (int(out.sum()), 2))
    return p0, p1.astype(np.float32)


def _idx(seed, set_size, iters=256):
    key = jax.random.PRNGKey(seed)
    return key, np.array(jr._sample_minimal_sets(key, N, iters, set_size))


def _masks_agree(got, ref, res, threshold):
    """Inlier masks equal except for points within 1e-3 of the threshold."""
    differ = got != ref
    assert (np.abs(res[differ] - threshold) < 1e-3).all(), int(differ.sum())


def test_sample_minimal_sets_shape_and_range():
    g = torch.Generator().manual_seed(0)
    idx = tr._sample_minimal_sets(50, 64, 4, g, torch.device("cpu"))
    assert idx.shape == (64, 4) and int(idx.min()) >= 0 and int(idx.max()) < 50
    with pytest.raises(ValueError, match="idx"):
        tr.fit_affine_ransac(torch.zeros(9, 2), torch.zeros(9, 2),
                             idx=torch.zeros((4, 5), dtype=torch.long))


@pytest.mark.parametrize("seed", [0, 1])
def test_homography_lstsq_motion_field(seed):
    """Over the frame the two motion fields agree within 0.02 px."""
    p0, p1 = _scene(seed, "homography")
    Hj = jr.fit_homography_lstsq(jnp.asarray(p0), jnp.asarray(p1))
    Ht = tr.fit_homography_lstsq(torch.from_numpy(p0), torch.from_numpy(p1))
    assert float(Ht[2, 2]) == pytest.approx(1.0)
    ref = np.asarray(jgm.homography_motion_field(Hj, H, W))
    got = tgm.homography_motion_field(Ht, H, W).numpy()
    assert np.abs(got - ref).max() < 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_ransac(seed):
    p0, p1 = _scene(seed, "affine")
    key, idx = _idx(seed, 3)
    Mj, inj = jr.fit_affine_ransac(jnp.asarray(p0), jnp.asarray(p1), key)
    Mt, int_ = tr.fit_affine_ransac(torch.from_numpy(p0), torch.from_numpy(p1),
                                    idx=torch.from_numpy(idx))
    res = np.asarray(jr._affine_residuals(Mj, jnp.asarray(p0), jnp.asarray(p1)))
    got_res = tr._affine_residuals(Mt[None], torch.from_numpy(p0),
                                   torch.from_numpy(p1))[0].numpy()
    inj = np.asarray(inj)
    assert inj.sum() > 0.7 * N
    assert (int_.numpy() == inj).mean() >= 0.995    # near-threshold points
    np.testing.assert_allclose(got_res[inj], res[inj], atol=1e-2)
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_homography_ransac(seed):
    p0, p1 = _scene(seed, "homography")
    key, idx = _idx(seed, 4)
    Hj, inj = jr.fit_homography_ransac(jnp.asarray(p0), jnp.asarray(p1), key)
    Ht, int_ = tr.fit_homography_ransac(torch.from_numpy(p0),
                                        torch.from_numpy(p1),
                                        idx=torch.from_numpy(idx))
    inj = np.asarray(inj)
    assert inj.sum() > 0.7 * N
    assert (int_.numpy() == inj).mean() >= 0.995
    res = np.asarray(jr._homography_residuals(Hj, jnp.asarray(p0), jnp.asarray(p1)))
    got = tr._homography_residuals(Ht, torch.from_numpy(p0),
                                   torch.from_numpy(p1)).numpy()
    np.testing.assert_allclose(got[inj], res[inj], atol=1e-2)


@pytest.mark.parametrize("essential", [False, True])
def test_epipolar_hypotheses_agree_on_generic_sets(essential):
    """A minimal set that draws one point twice (the sets are drawn with
    replacement: 18 of 256 here) has a null space of two dimensions, and
    LAPACK reached through JAX and through torch returns different vectors of
    it: such a hypothesis is arbitrary in both packages and scores
    differently. Every set of eight distinct points must score the same
    (within 2 inliers: points on the threshold)."""
    p0, p1 = _scene(0, "epipolar")
    _, idx = _idx(0, 8)
    scale, thr = (100.0, 0.01) if essential else (1.0, 0.999)
    a0, a1 = jnp.asarray(p0 / scale), jnp.asarray(p1 / scale)
    t0, t1 = torch.from_numpy(p0 / scale), torch.from_numpy(p1 / scale)
    hj = jax.vmap(lambda i: jr._eightpoint(a0[i], a1[i], jnp.ones(8), essential)
                  )(jnp.asarray(idx))
    ht = tr._eightpoint(t0[idx], t1[idx], torch.ones(len(idx), 8), essential)
    sj = (np.asarray(jax.vmap(lambda F: jr._sampson_dist(F, a0, a1))(hj))
          < thr).sum(1)
    st = (tr._sampson_dist(ht, t0, t1).numpy() < thr).sum(1)
    generic = np.array([len(set(row)) == 8 for row in idx])
    assert 0 < (~generic).sum() < 64
    assert np.abs(sj - st)[generic].max() <= 2


@pytest.mark.parametrize("essential", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_epipolar_ransac(seed, essential):
    """Sampson distances of the inliers within 1e-2 (in the fit's units);
    the matrix itself up to sign. The keys are ones whose winning hypothesis
    comes from eight distinct points (see the test above)."""
    p0, p1 = _scene(seed, "epipolar")
    key, idx = _idx(seed, 8)
    a0, a1 = jnp.asarray(p0), jnp.asarray(p1)
    t0, t1 = torch.from_numpy(p0), torch.from_numpy(p1)
    if essential:
        Fj, inj = jr.fit_essential_ransac(a0, a1, key, focal=100.0)
        Ft, int_ = tr.fit_essential_ransac(t0, t1, idx=torch.from_numpy(idx),
                                           focal=100.0)
        scale, thr = 100.0, 1.0 / 100.0
    else:
        Fj, inj = jr.fit_fundamental_ransac(a0, a1, key)
        Ft, int_ = tr.fit_fundamental_ransac(t0, t1, idx=torch.from_numpy(idx))
        scale, thr = 1.0, 0.999
    inj = np.asarray(inj)
    assert inj.sum() > 0.5 * N
    dj = np.asarray(jr._sampson_dist(Fj, a0 / scale, a1 / scale))
    dt = tr._sampson_dist(Ft, t0 / scale, t1 / scale).numpy()
    np.testing.assert_allclose(dt[inj], dj[inj], atol=1e-2 / scale)
    agree = (int_.numpy() == inj)
    near = np.abs(dj - thr) < 2e-2 / scale
    assert (agree | near).all(), int((~agree & ~near).sum())
    Fj = np.asarray(Fj)
    sign = np.sign((Fj * Ft.numpy()).sum())
    np.testing.assert_allclose(sign * Ft.numpy(), Fj, atol=5e-3)
    assert float(torch.linalg.norm(Ft)) == pytest.approx(1.0, abs=1e-5)


def test_degenerate_minimal_sets_count_as_outliers():
    """A set that repeats one point gives a singular system: its residuals
    are non-finite and score nothing, and the fit still finds the model."""
    p0, p1 = _scene(3, "affine")
    _, idx = _idx(3, 3, iters=32)
    idx[:16] = idx[:16, :1]                      # three times the same point
    M, inl = tr.fit_affine_ransac(torch.from_numpy(p0), torch.from_numpy(p1),
                                  idx=torch.from_numpy(idx))
    assert torch.isfinite(M).all() and int(inl.sum()) > 0.7 * N
    idx4 = np.repeat(idx[:, :1], 4, 1)           # every set degenerate
    Hm, inl = tr.fit_homography_ransac(torch.from_numpy(p0), torch.from_numpy(p1),
                                       idx=torch.from_numpy(idx4))
    assert Hm.shape == (3, 3)


def test_decompose_essential_and_euler():
    a = 0.2
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.3, -0.2, 0.9], np.float32)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    E = tx @ R
    ref = jr.decompose_essential(jnp.asarray(E))
    got = tr.decompose_essential(torch.from_numpy(E))
    # the two rotations come from the same SVD up to the sign of its last
    # vectors; compare as a set, and t up to sign
    refs = [np.asarray(ref[0]), np.asarray(ref[1])]
    for g in (got[0].numpy(), got[1].numpy()):
        assert np.linalg.det(g) == pytest.approx(1.0, abs=1e-4)
        assert min(np.abs(g - r).max() for r in refs) < 1e-4
    tj, tt = np.asarray(ref[2]), got[2].numpy()
    assert min(np.abs(tt - tj).max(), np.abs(tt + tj).max()) < 1e-4
    for Rm in (R, np.asarray(ref[0]), np.eye(3, dtype=np.float32)[[2, 1, 0]] * [-1, 1, 1]):
        Rm = np.asarray(Rm, np.float32)
        np.testing.assert_allclose(
            tr.rotation_matrix_to_euler(torch.from_numpy(Rm)).numpy(),
            np.asarray(jr.rotation_matrix_to_euler(jnp.asarray(Rm))), atol=1e-4)

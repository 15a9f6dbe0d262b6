"""The port's Shi-Tomasi corners and pyramidal Lucas-Kanade held to the JAX
package's on seeded textured frames (CPU, float32)."""
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, map_coordinates

import jax.numpy as jnp

from mav_detection_tpu.ops.flow import lucas_kanade as jl

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.ops.flow import farneback as tfb
from mav_detection_tpu_torch.ops.flow import lucas_kanade as tl

# Tiny shapes: one intra-op thread, so that test workers running side by side
# do not oversubscribe the cores (thousands of small ops, each a thread barrier).
torch.set_num_threads(1)

H, W = 96, 128


def _texture(seed, sigma=1.2, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (gaussian_filter(rng.random((h, w)), sigma) * 255).astype(np.float32)


def _moved(img, dx, dy, zoom=0.0):
    """img seen after a shift (dx, dy) plus a zoom about the centre."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = xs - dx - zoom * (xs - w / 2)
    sy = ys - dy - zoom * (ys - h / 2)
    return map_coordinates(img, [sy, sx], order=1, mode="nearest").astype(np.float32)


def _corner_set(c):
    pts, valid = np.asarray(c.points), np.asarray(c.valid)
    return {(float(x), float(y)) for (x, y), v in zip(pts, valid) if v}


def test_sep_correlate_matches_jax():
    """Two banded fp32 matmuls on both sides: 1e-4 on values of ~1e3."""
    from mav_detection_tpu.ops.flow.farneback import _sep_correlate as j_sep

    img = _texture(0)
    img3 = np.stack([img, img[::-1], img * 0.5], -1)
    kv, kh = (1.0, 2.0, 1.0), (0.1, 0.2, 0.4, 0.2, 0.1)
    for x in (img, img3):
        for mode in ("edge", "reflect"):
            ref = np.asarray(j_sep(jnp.asarray(x), kv, kh, mode, "highest"))
            got = tfb._sep_correlate(torch.from_numpy(x), kv, kh, mode).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(max_corners=100, quality_level=0.05)),
    (1, dict(max_corners=40, quality_level=0.01)),          # the cap bites
    (2, dict(max_corners=200, quality_level=0.2)),          # fewer than K pass
    (3, dict(max_corners=60, quality_level=0.05, min_distance=3, block_size=5)),
    (4, dict(max_corners=30, quality_level=0.05, min_distance=15)),
])
def test_corners_equal_as_a_set(seed, kw):
    """Same candidates in the same order, same greedy sweep: the accepted
    corners are the same pixels, slot by slot."""
    img = _texture(seed)
    ref = jl.shi_tomasi_corners(jnp.asarray(img), **kw)
    got = tl.shi_tomasi_corners(torch.from_numpy(img), **kw)
    assert _corner_set(got) == _corner_set(ref)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.points.numpy()[v], np.asarray(ref.points)[v])
    np.testing.assert_allclose(got.response.numpy(), np.asarray(ref.response),
                               rtol=1e-4, atol=1e-2)
    assert got.points.shape == (kw["max_corners"], 2)


def test_greedy_sweep_against_the_sequential_loop():
    """The round-based sweep against a literal sequential sweep, on a dense
    random candidate field where chains of conflicts are long."""
    rng = np.random.default_rng(0)
    h, w, n = 60, 80, 1500
    flat = rng.permutation(h * w)[:n]
    cx, cy = flat % w, flat // w
    ok = rng.random(n) < 0.9
    for min_distance in (1, 2, 7, 12):
        accepted = []
        want = np.zeros(n, bool)
        for i in range(n):
            if ok[i] and all((cx[i] - cx[j]) ** 2 + (cy[i] - cy[j]) ** 2
                             >= min_distance ** 2 for j in accepted):
                accepted.append(i)
                want[i] = True
        got = tl._greedy_min_distance(torch.from_numpy(cx), torch.from_numpy(cy),
                                      torch.from_numpy(ok), h, w, min_distance)
        np.testing.assert_array_equal(got.numpy(), want)


def test_flat_image_has_no_corner():
    got = tl.shi_tomasi_corners(torch.full((40, 50), 7.0), max_corners=20)
    ref = jl.shi_tomasi_corners(jnp.full((40, 50), 7.0), max_corners=20)
    assert not got.valid.any() and not np.asarray(ref.valid).any()
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))


@pytest.mark.parametrize("seed,move", [(0, (1.3, -0.7, 0.0)), (1, (-2.6, 1.9, 0.01)),
                                       (2, (0.0, 0.0, 0.0))])
def test_tracks_match_jax(seed, move):
    """Tracks within 1e-2 px; status equal except where the end point sits
    within 1e-3 px of the frame's edge. Held on the features the reference
    tracked (a lost track has run off by tens of pixels on both sides) whose
    21x21 window lies inside the frame: a window clamped at the border makes
    the 2x2 system near-singular, and there fp32 rounding alone moves the
    reference's own answer by tenths of a pixel (it reports 0.3 px of motion
    between two identical frames at (35, 4))."""
    img0 = _texture(seed)
    img1 = _moved(img0, *move)
    corners = jl.shi_tomasi_corners(jnp.asarray(img0), max_corners=80,
                                    quality_level=0.05)
    pts = np.asarray(corners.points)
    ref = jl.lucas_kanade_track(jnp.asarray(img0), jnp.asarray(img1), corners.points)
    got = tl.lucas_kanade_track(torch.from_numpy(img0), torch.from_numpy(img1),
                                torch.from_numpy(pts))
    held = (np.asarray(ref.status) & (pts[:, 0] >= 10) & (pts[:, 0] <= W - 11)
            & (pts[:, 1] >= 10) & (pts[:, 1] <= H - 11))
    assert held.sum() >= 40
    np.testing.assert_allclose(got.points.numpy()[held],
                               np.asarray(ref.points)[held], atol=1e-2)
    np.testing.assert_allclose(got.error.numpy()[held],
                               np.asarray(ref.error)[held], atol=1e-2)
    assert np.isfinite(got.points.numpy()).all()
    differ = got.status.numpy() != np.asarray(ref.status)
    p = np.asarray(ref.points)[differ]
    on_edge = (np.abs(p[:, 0]) < 1e-3) | (np.abs(p[:, 0] - (W - 1)) < 1e-3) \
        | (np.abs(p[:, 1]) < 1e-3) | (np.abs(p[:, 1] - (H - 1)) < 1e-3)
    assert on_edge.all(), int(differ.sum())
    ok = np.asarray(corners.valid) & got.status.numpy()
    disp = (got.points.numpy() - pts)[ok]
    np.testing.assert_allclose(np.median(disp, 0), move[:2], atol=0.15)


def test_a_converged_lane_freezes_while_others_go_on():
    """One level, two features: over an unmoved patch the first step is
    below eps and the lane must stop there; over a patch moved by 3 px the
    lane needs more than 5 iterations. Cutting the loop at 1, 5 and 30
    iterations shows both: lane A never changes after iteration 1, lane B
    still moves between 5 and 30, and both match the reference, whose
    per-feature loop ends each lane on its own."""
    img0 = _texture(7, sigma=2.5)
    img1 = img0.copy()
    moved = _moved(img0, 3.0, 0.0)
    img1[:, 64:] = moved[:, 64:]              # right half moves, left does not
    pts = np.array([[30.0, 48.0], [96.0, 48.0]], np.float32)
    runs = {}
    for iters in (1, 5, 30):
        got = tl.lucas_kanade_track(torch.from_numpy(img0), torch.from_numpy(img1),
                                    torch.from_numpy(pts), iters=iters, levels=1)
        ref = jl.lucas_kanade_track(jnp.asarray(img0), jnp.asarray(img1),
                                    jnp.asarray(pts), iters=iters, levels=1)
        np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                                   atol=1e-2)
        runs[iters] = got.points.numpy() - pts
    # lane A: converged at its first step, frozen from then on
    assert np.linalg.norm(runs[1][0]) < 0.01
    np.testing.assert_array_equal(runs[5][0], runs[1][0])
    np.testing.assert_array_equal(runs[30][0], runs[1][0])
    # lane B: not there after 5 iterations, goes on, arrives
    assert np.linalg.norm(runs[30][1] - runs[5][1]) > 0.05
    np.testing.assert_allclose(runs[30][1], [3.0, 0.0], atol=0.1)


def test_lk_dense_flow_matches_jax():
    """Dense field within 2e-2 px of the reference's."""
    img0 = _texture(3)
    img1 = _moved(img0, 1.5, -1.0, zoom=0.01)
    ref = np.asarray(jl.lk_dense_flow(jnp.asarray(img0), jnp.asarray(img1),
                                      max_corners=150))
    got = tl.lk_dense_flow(torch.from_numpy(img0), torch.from_numpy(img1),
                           max_corners=150).numpy()
    assert got.shape == (H, W, 2) and got.dtype == np.float32
    assert np.abs(got - ref).max() < 2e-2
    assert np.abs(got[16:-16, 16:-16] - [1.5, -1.0]).mean() < 0.5


def test_replenish_features_and_carried_state():
    img = _texture(5)
    rng = np.random.default_rng(5)
    pool = dict(points=rng.uniform(10, 80, (50, 2)).astype(np.float32),
                valid=rng.random(50) < 0.5)
    ref = jl.replenish_features(
        jl.FeaturePool(jnp.asarray(pool["points"]), jnp.asarray(pool["valid"])),
        jnp.asarray(img), max_corners=50)
    got = tl.replenish_features(convert.feature_pool_from_reference(pool),
                                torch.from_numpy(img), max_corners=50)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    # corners and tracks cross as numpy both ways
    cj = jl.shi_tomasi_corners(jnp.asarray(img), max_corners=30)
    ct = convert.corners_from_reference(
        {k: np.asarray(v) for k, v in cj._asdict().items()})
    assert _corner_set(ct) == _corner_set(cj)
    tj = jl.lucas_kanade_track(jnp.asarray(img), jnp.asarray(img), cj.points)
    tt = convert.track_result_from_reference(
        {k: np.asarray(v) for k, v in tj._asdict().items()})
    assert tt.status.dtype == torch.bool and tt.points.shape == (30, 2)
    back = convert.state_to_numpy(tt)
    np.testing.assert_array_equal(back["points"], np.asarray(tj.points))

"""The port's sparse FoE and trace ring held to the JAX package's on the
cases of tests/test_foe_traces.py and tests/test_pipeline.py::TestSparseFoe:
1e-3 px, with the rolled pairing and with JAX's permutation fed in. The
one-frame grid fixture is the exception: its motion lines are ~1 px long and
nearly parallel to their partners', so the intersection divides a cancelling
difference of ~4e4-sized products by a small determinant, and XLA's fused
multiply-adds move the winning point by up to 1.3e-4 relative (0.02 px at
150 px; 24 seeds x 2 pairings): those cases are held to 0.05 px."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.ops.geometry import foe as jf

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.ops.geometry import foe as tf

FOE = np.array([160.0, 120.0])
EXPANSION = 0.01
TOL_PX = 1e-3
GRID_TOL_PX = 0.05


def _advance(pts, noise):
    return pts + EXPANSION * (pts - FOE) + noise


def _simulate(n_tracks=64, n_frames=25, noise_px=0.3, seed=0,
              replenish_at=None, replenish_slots=(), drop=()):
    """Both packages' trace states over one radially expanding track field."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([40, 40], [280, 200], size=(n_tracks, 2))
    sj, st = jf.trace_init(n_tracks), tf.trace_init(n_tracks)
    valid = np.ones(n_tracks, bool)
    valid[list(drop)] = False
    for f in range(n_frames):
        new_track = np.zeros(n_tracks, bool)
        if f:
            pts = _advance(pts, rng.normal(scale=noise_px, size=(n_tracks, 2)))
            if f == replenish_at:
                new_track[list(replenish_slots)] = True
                pts[list(replenish_slots)] = rng.uniform(
                    [40, 40], [280, 200], size=(len(replenish_slots), 2))
        p32 = pts.astype(np.float32)
        sj = jf.trace_update(sj, jnp.asarray(p32), jnp.asarray(valid),
                             jnp.asarray(new_track))
        st = tf.trace_update(st, torch.from_numpy(p32), torch.from_numpy(valid),
                             torch.from_numpy(new_track))
    return sj, st, pts


def _perm(seed, n):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.permutation(key, n))


def _grid_fixture(seed, noise_px=0.15):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(48.0, 272.0, 12), np.linspace(48.0, 192.0, 8))
    pts0 = np.stack([gx.ravel(), gy.ravel()], -1)
    pts1 = _advance(pts0, rng.normal(scale=noise_px, size=pts0.shape))
    return pts0.astype(np.float32), pts1.astype(np.float32)


@pytest.mark.parametrize("seed", [100, 101, 107])
@pytest.mark.parametrize("keyed", [False, True])
def test_get_foe_sparse_grid(seed, keyed):
    p0, p1 = _grid_fixture(seed)
    valid = np.ones(len(p0), bool)
    key, perm = _perm(seed, len(p0)) if keyed else (None, None)
    ref = np.asarray(jf.get_foe_sparse(jnp.asarray(p0), jnp.asarray(p1),
                                       jnp.asarray(valid), key=key))
    got = tf.get_foe_sparse(torch.from_numpy(p0), torch.from_numpy(p1),
                            torch.from_numpy(valid),
                            perm=None if perm is None else torch.from_numpy(perm))
    np.testing.assert_allclose(got.numpy(), ref, atol=GRID_TOL_PX)
    assert np.isfinite(got.numpy()).all()


def test_get_foe_sparse_from_tracks_and_partial_validity():
    rng = np.random.default_rng(0)
    foe = np.array([80.0, 40.0])
    new = rng.uniform(0, 120, (256, 2)).astype(np.float32)
    old = (new - 0.1 * (new - foe)).astype(np.float32)
    valid = rng.random(256) < 0.8
    old[:10] = new[:10]                       # stationary tracks must not vote
    ref = np.asarray(jf.get_foe_sparse(jnp.asarray(old), jnp.asarray(new),
                                       jnp.asarray(valid)))
    got = tf.get_foe_sparse(torch.from_numpy(old), torch.from_numpy(new),
                            torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_PX)
    np.testing.assert_allclose(got, foe, atol=2.0)


def test_get_foe_sparse_no_valid_tracks():
    pts = torch.zeros((32, 2))
    got = tf.get_foe_sparse(pts, pts, torch.zeros(32, dtype=torch.bool))
    ref = np.asarray(jf.get_foe_sparse(jnp.zeros((32, 2)), jnp.zeros((32, 2)),
                                       jnp.zeros(32, bool)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), [0.0, 0.0])


TRACE_CASES = {
    "noisy": dict(noise_px=0.4),
    "noiseless": dict(noise_px=0.0),
    "short_history": dict(n_frames=5, noise_px=0.0),
    "ring_wrapped": dict(n_frames=47, noise_px=0.2),
    "replenished": dict(noise_px=0.2, replenish_at=20, replenish_slots=range(0, 64, 2)),
    "dropped_tracks": dict(noise_px=0.2, drop=range(0, 64, 3)),
}


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
@pytest.mark.parametrize("keyed", [False, True])
def test_trace_state_and_traced_foe(name, keyed):
    sj, st, _ = _simulate(**TRACE_CASES[name])
    assert st.head == int(sj.head)
    np.testing.assert_array_equal(st.positions.numpy(), np.asarray(sj.positions))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(sj.alive))
    np.testing.assert_array_equal(st.age.numpy(), np.asarray(sj.age))
    assert st.age.dtype == torch.int32
    key, perm = _perm(3, 64) if keyed else (None, None)
    ref = np.asarray(jf.get_foe_sparse_traced(sj, key=key))
    got = tf.get_foe_sparse_traced(
        st, perm=None if perm is None else torch.from_numpy(perm)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_PX)


def test_traced_foe_quality_and_options():
    sj, st, pts = _simulate(noise_px=0.4)
    traced = tf.get_foe_sparse_traced(st).numpy()
    prev = st.positions[(st.head - 1) % st.positions.shape[0]]
    single = tf.get_foe_sparse(prev, torch.from_numpy(pts.astype(np.float32)),
                               torch.ones(64, dtype=torch.bool)).numpy()
    assert np.linalg.norm(traced - FOE) < 10.0
    assert np.linalg.norm(traced - FOE) < np.linalg.norm(single - FOE)
    for kw in (dict(rollback=5), dict(min_baseline=3.0), dict(ransac_threshold=10.0)):
        np.testing.assert_allclose(
            tf.get_foe_sparse_traced(st, **kw).numpy(),
            np.asarray(jf.get_foe_sparse_traced(sj, **kw)), atol=TOL_PX)


def test_empty_and_carried_trace_state():
    """A fresh ring votes (0, 0) like the reference's, and a reference state
    carried across as numpy gives the same FoE."""
    np.testing.assert_array_equal(
        tf.get_foe_sparse_traced(tf.trace_init(16)).numpy(),
        np.asarray(jf.get_foe_sparse_traced(jf.trace_init(16))))
    sj, st, _ = _simulate(noise_px=0.2)
    carried = convert.trace_state_from_reference(
        {k: np.asarray(v) for k, v in sj._asdict().items()})
    np.testing.assert_allclose(tf.get_foe_sparse_traced(carried).numpy(),
                               np.asarray(jf.get_foe_sparse_traced(sj)), atol=TOL_PX)
    back = convert.state_to_numpy(st)
    assert back["positions"].shape == (21, 64, 2) and int(back["head"]) == st.head

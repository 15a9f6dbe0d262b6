"""The port's k-means held to the JAX package's with JAX's initial centers
fed in. Sums run in another order, and a point equidistant from two centers
to fp32 rounding may take either label."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import importlib

jk = importlib.import_module("mav_detection_tpu.ops.geometry.kmeans")
tk = importlib.import_module("mav_detection_tpu_torch.ops.geometry.kmeans")


def jax_init_idx(key, n, k=8, attempts=10):
    """The reference's draw: one ``choice`` without replacement per attempt,
    keys from ``split(key, attempts)``."""
    return np.stack([np.asarray(jax.random.choice(sub, n, (k,), replace=False))
                     for sub in jax.random.split(key, attempts)])


def _blobs(seed, n=600, d=2, k=5):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, d))
    return (centers[rng.integers(0, k, n)]
            + rng.normal(scale=0.7, size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("seed,d,k", [(0, 2, 8), (1, 1, 8), (2, 3, 4)])
def test_kmeans_matches_jax(seed, d, k):
    pts = _blobs(seed, d=d)
    key = jax.random.PRNGKey(seed)
    comp_j, lab_j, cen_j = jk.kmeans(jnp.asarray(pts), key, k=k)
    init = jax_init_idx(key, len(pts), k=k)
    comp_t, lab_t, cen_t = tk.kmeans(torch.from_numpy(pts),
                                     torch.from_numpy(init), k=k)
    np.testing.assert_allclose(cen_t.numpy(), np.asarray(cen_j), rtol=1e-3,
                               atol=1e-3)
    assert (lab_t.numpy() == np.asarray(lab_j)).mean() >= 0.999
    assert float(comp_t) == pytest.approx(float(comp_j), rel=1e-4)


def test_empty_cluster_keeps_its_center():
    """Two far-apart duplicate groups and k=3 with two seeds in one group:
    one cluster goes empty and must keep its center."""
    pts = np.concatenate([np.zeros((20, 1)), np.full((20, 1), 10.0)]).astype(np.float32)
    init = np.array([[0, 1, 20]])                    # centers 0, 0, 10
    _, lab, cen = tk.kmeans(torch.from_numpy(pts), torch.from_numpy(init),
                            k=3, attempts=1)
    np.testing.assert_allclose(np.sort(cen.numpy()[:, 0]), [0.0, 0.0, 10.0])
    assert set(lab.numpy().tolist()) == {0, 2}       # argmin takes the first


def test_draw_without_init_is_seeded_and_distinct():
    pts = torch.from_numpy(_blobs(4))
    a = tk.kmeans(pts, generator=torch.Generator().manual_seed(5))
    b = tk.kmeans(pts, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    with pytest.raises(ValueError, match="init_idx"):
        tk.kmeans(pts, torch.zeros((10, 3), dtype=torch.long))


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_image_matches_jax(seed):
    rng = np.random.default_rng(seed)
    img = rng.gamma(1.5, 1.0, (48, 64)).astype(np.float32)
    img[20:28, 30:40] += 12.0                         # the bright target
    key = jax.random.PRNGKey(seed)
    q_j, m_j = jk.cluster_image(jnp.asarray(img), key)
    init = jax_init_idx(key, img.size)
    q_t, m_t = tk.cluster_image(torch.from_numpy(img), torch.from_numpy(init))
    assert q_t.dtype == torch.uint8 and m_t.dtype == torch.bool
    assert (m_t.numpy() == np.asarray(m_j)).mean() >= 0.999
    assert (q_t.numpy() == np.asarray(q_j)).mean() >= 0.999
    assert m_t.numpy()[20:28, 30:40].mean() > 0.5

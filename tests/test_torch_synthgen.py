"""The port's on-device scene generator (``mav_detection_tpu_torch.data.synthgen``)
against the JAX package's, on the same draws, and the physical properties
``tests/test_synthgen.py`` checks of the reference."""
import jax
import numpy as np
import pytest
import torch

from mav_detection_tpu.data import synthgen as js
from mav_detection_tpu_torch.data import synthgen as ts
from mav_detection_tpu_torch.ops.geometry.warp import sample_bilinear_replicate
from torch_train_helpers import port_draws

torch.set_num_threads(1)

H, W = 96, 128
# every field within 1e-5 of its own scale (the largest magnitude of the
# reference's field): the blurs are banded fp32 matmuls in both packages,
# summed in another order
REL_TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(20261017)


def _assert_scene_close(ref, out):
    for f in ts.SynthScene._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(out, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == bool:
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=REL_TOL * max(np.abs(a).max(), 1e-30), err_msg=f)


@pytest.mark.parametrize("pan_max", [0.0, 12.0])
@pytest.mark.parametrize("seed", [0, 5])
def test_scene_matches_jax_on_fed_draws(seed, pan_max):
    key = jax.random.PRNGKey(seed)
    ref = js.generate_scene(key, H, W, pan_max=pan_max)
    out = ts.generate_scene(H, W, pan_max=pan_max,
                            draws=port_draws([key], H, W, pan_max), device="cpu")
    _assert_scene_close(ref, out)


@pytest.mark.parametrize("pan_max", [0.0, 6.0])
def test_batch_matches_jax_generate_batch(pan_max):
    key = jax.random.PRNGKey(3)
    ref = js.generate_batch(key, 3, 48, 64, pan_max=pan_max)
    keys = jax.random.split(key, 3)
    out = ts.generate_batch(3, 48, 64, pan_max=pan_max,
                            draws=port_draws(keys, 48, 64, pan_max), device="cpu")
    # vmap reassociates the texture reductions (test_synthgen.py says so of
    # the reference itself): within 0.05 grey levels, the masks exact
    for f in ts.SynthScene._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        if a.dtype == bool:
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(b, a, atol=0.05, err_msg=f)


def test_batch_is_its_scenes():
    """One batched render equals the scenes rendered one by one."""
    draws = ts.draw_scenes(3, H, W, generator=torch.Generator().manual_seed(1))
    batch = ts.generate_batch(3, H, W, draws=draws, device="cpu")
    for i in range(3):
        one = ts.generate_scene(H, W, draws=ts.SceneDraws(*(t[i:i + 1] for t in draws)),
                                device="cpu")
        for f in ts.SynthScene._fields:
            a, b = getattr(one, f), getattr(batch, f)[i]
            assert torch.allclose(a.to(torch.float32), b.to(torch.float32),
                                  atol=1e-4), f


def test_draws_cover_the_reference_ranges():
    d = ts.draw_scenes(64, 8, 8, pan_max=3.0, generator=torch.Generator().manual_seed(0))
    for name, lo, hi in (("horizon", 0.2, 0.45), ("foe", 0.2, 0.8),
                         ("expansion", 0.002, 0.022), ("omega", -0.005, 0.005),
                         ("pan", -3.0, 3.0), ("radius", 3.0, 14.0),
                         ("pos", ts.MARGIN, 1 - ts.MARGIN), ("vel", -5.0, 5.0),
                         ("style", 0.0, 1.0), ("aug", 0.0, 1.0)):
        t = getattr(d, name)
        assert float(t.min()) >= lo and float(t.max()) < hi, name
    assert d.ground_noise.shape == (64, 8 + 2 * 11, 8 + 2 * 11)


def test_wrong_draw_size_raises():
    d = ts.draw_scenes(1, H, W)
    with pytest.raises(ValueError, match="renders 18 px larger"):
        ts.generate_batch(1, H, W, pan_max=1.0, draws=d, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        ts.generate_batch(1, H, W)


# ---- the properties of tests/test_synthgen.py, on the port
def _scene(seed, pan_max=0.0):
    return ts.generate_scene(H, W, pan_max=pan_max, device="cpu",
                             generator=torch.Generator().manual_seed(seed))


def _photometric_err(s, border):
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    flow = s.flow.numpy()
    warped = sample_bilinear_replicate(s.img2, torch.from_numpy(xs + flow[..., 0]),
                                       torch.from_numpy(ys + flow[..., 1])).numpy()
    m = ~s.seg.numpy()
    m[:border] = m[-border:] = False
    m[:, :border] = m[:, -border:] = False
    hy = int(s.sky.numpy().sum(0).max())
    m[max(hy - 6, 0):hy + 6] = False
    return np.abs(warped - s.img1.numpy())[m]


def test_shapes_and_ranges():
    s = _scene(0)
    assert s.img1.shape == (H, W) and s.flow.shape == (H, W, 2)
    assert s.sky.dtype == torch.bool and s.seg.dtype == torch.bool
    assert float(s.img1.min()) >= 0 and float(s.img1.max()) <= 255
    assert torch.isfinite(s.flow).all()


@pytest.mark.parametrize("pan_max,border", [(0.0, 8), (12.0, 22)])
def test_photometric_consistency(pan_max, border):
    err = _photometric_err(_scene(3, pan_max), border)
    assert err.mean() < 5.0 and np.percentile(err, 95) < 12.0


def test_sky_brighter_than_ground():
    s = _scene(7)
    img, sky, seg = s.img1.numpy(), s.sky.numpy(), s.seg.numpy()
    assert img[sky & ~seg].mean() > img[~sky & ~seg].mean() + 20


def test_box_matches_segmentation():
    s = _scene(5)
    seg = s.seg.numpy()
    assert seg.any()
    ys, xs = np.nonzero(seg)
    cx, cy, bw, bh = s.box.numpy()
    assert abs(xs.mean() - cx) < 2.0 and abs(ys.mean() - cy) < 2.0
    assert xs.max() - xs.min() <= bw + 1 and ys.max() - ys.min() <= bh + 1


@pytest.mark.parametrize("pan_max", [0.0, 12.0])
def test_drone_flow_override(pan_max):
    s = _scene(9, pan_max)
    inside = s.flow.numpy()[s.seg.numpy()]
    assert inside.size and np.ptp(inside[:, 0]) < 1e-5 and np.ptp(inside[:, 1]) < 1e-5


def test_deterministic_per_generator_seed():
    a, b, c = _scene(11), _scene(11), _scene(12)
    assert torch.equal(a.img1, b.img1)
    assert (a.img1 - c.img1).abs().mean() > 1.0


def test_pan_reaches_large_motion():
    peak = max(float(_scene(k, 12.0).flow.abs().max()) for k in range(6))
    assert peak > 8.0, peak

"""The port's image ops held to the JAX package's: the host visualize
functions are numpy copies and must be bit-equal; the tensor functions run
the same math in float32 on the CPU. Inputs are seeded numpy arrays."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mav_detection_tpu.ops.image import color as jcolor
from mav_detection_tpu.ops.image import metrics as jmetrics
from mav_detection_tpu.ops.image import visualize as jvis
from mav_detection_tpu.ops.image.resize import resize as j_resize
from mav_detection_tpu.ops.image.resize import resize_percent as j_resize_percent
from mav_detection_tpu.ops.image.resize import resize_width as j_resize_width

from mav_detection_tpu_torch.data.dataset import imread, imwrite, png_decode, png_encode
from mav_detection_tpu_torch.ops.image import color as tcolor
from mav_detection_tpu_torch.ops.image import get_magnitude, get_rho
from mav_detection_tpu_torch.ops.image import visualize as tvis
from mav_detection_tpu_torch.ops.image.resize import resize, resize_percent, resize_width

RNG = np.random.default_rng(7)
FLOW = (RNG.normal(size=(48, 64, 2)) * 4).astype(np.float32)


@pytest.mark.parametrize("fn,jfn", [(get_magnitude, jmetrics.get_magnitude),
                                    (get_rho, jmetrics.get_rho)])
@pytest.mark.parametrize("shape", [(48, 64, 2), (3, 20, 30, 2)])
def test_flow_magnitude_and_angle_match_jax(fn, jfn, shape):
    """float32 on both sides; 1e-6 relative / 1e-6 rad absolute: the two
    libraries' sqrt and atan2 may round one ulp apart. Axes and the zero
    vector as well (atan2(0, 0) = 0, atan2(0, -1) = pi)."""
    flow = (np.random.default_rng(len(shape)).normal(size=shape) * 4).astype(np.float32)
    flow[..., 0, 0, :] = 0.0
    flow[..., 0, 1, :] = (-1.0, 0.0)
    flow[..., 0, 2, :] = (0.0, -2.0)
    got = fn(torch.from_numpy(flow))
    want = np.asarray(jfn(jnp.asarray(flow)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


class TestHostVisualize:
    """Copies of numpy code: bit-equal."""

    def test_tables(self):
        np.testing.assert_array_equal(tvis._COLORWHEEL, jvis._COLORWHEEL)
        np.testing.assert_array_equal(tvis._JET, jvis._JET)

    @pytest.mark.parametrize("kw", [{}, dict(convert_to_bgr=False),
                                    dict(rad_max=3.0)])
    def test_flow_to_color(self, kw):
        np.testing.assert_array_equal(tvis.flow_to_color(FLOW, **kw),
                                      jvis.flow_to_color(FLOW, **kw))

    def test_flow_to_color_nonfinite_pixel(self):
        bad = FLOW.copy()
        bad[3, 4] = np.nan
        bad[5, 6, 0] = np.inf
        np.testing.assert_array_equal(tvis.flow_to_color(bad),
                                      jvis.flow_to_color(bad))

    @pytest.mark.parametrize("kw", [dict(normalize=True), dict(normalize=False),
                                    dict(normalize=True, max_value=2.0),
                                    dict(normalize=True, max_value=-1.0)])
    def test_to_int(self, kw):
        img = np.abs(FLOW[..., 0]) * 20
        np.testing.assert_array_equal(tvis.to_int(img, **kw), jvis.to_int(img, **kw))

    def test_to_rgb_apply_colormap(self):
        img = np.abs(FLOW[..., 1])
        np.testing.assert_array_equal(tvis.to_rgb(img), jvis.to_rgb(img))
        np.testing.assert_array_equal(tvis.to_rgb(img * 0), jvis.to_rgb(img * 0))
        np.testing.assert_array_equal(tvis.apply_colormap(img),
                                      jvis.apply_colormap(img))
        u8 = (img * 30).astype(np.uint8)
        np.testing.assert_array_equal(tvis.apply_colormap(u8),
                                      jvis.apply_colormap(u8))

    def test_radial_fft_legends(self):
        vis = jvis.flow_to_color(FLOW)
        np.testing.assert_array_equal(tvis.get_flow_radial(vis),
                                      jvis.get_flow_radial(vis))
        np.testing.assert_array_equal(tvis.get_fft_magnitude(vis),
                                      jvis.get_fft_magnitude(vis))
        np.testing.assert_array_equal(tvis.colorbar_image(), jvis.colorbar_image())
        np.testing.assert_array_equal(tvis.colorwheel_image(60),
                                      jvis.colorwheel_image(60))


class TestDeviceVisualize:
    """float32 on both sides; a value on a grey-level boundary may floor
    either way: within 1 level, and equal on >= 99 % of the values."""

    @pytest.mark.parametrize("rad_max", [None, 5.0])
    def test_flow_to_color_device(self, rad_max):
        ref = np.asarray(jvis.flow_to_color_device(jnp.asarray(FLOW), rad_max))
        got = tvis.flow_to_color_device(torch.from_numpy(FLOW), rad_max).numpy()
        assert got.shape == ref.shape == (48, 64, 3) and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1.0
        assert (got == ref).mean() >= 0.99
        host = tvis.flow_to_color(FLOW, rad_max=rad_max).astype(np.float32)
        assert np.abs(got - host).max() <= 1.0

    def test_flow_to_color_device_nonfinite(self):
        bad = FLOW.copy()
        bad[3, 4] = np.nan
        ref = np.asarray(jvis.flow_to_color_device(jnp.asarray(bad)))
        got = tvis.flow_to_color_device(torch.from_numpy(bad)).numpy()
        assert np.isfinite(got).all() and np.abs(got - ref).max() <= 1.0

    def test_flow_radial_device(self):
        ref = np.asarray(jvis.flow_radial_device(jnp.asarray(FLOW)))
        got = tvis.flow_radial_device(torch.from_numpy(FLOW)).numpy()
        assert np.abs(got - ref).max() <= 1.0
        assert (got == ref).mean() >= 0.99


class TestResize:
    IMG = RNG.random((48, 64)).astype(np.float32)
    IMG3 = RNG.random((48, 64, 3)).astype(np.float32)

    @pytest.mark.parametrize("shape", [(31, 40), (48, 64), (70, 90), (32, 96)])
    @pytest.mark.parametrize("img", [IMG, IMG3], ids=["hw", "hwc"])
    def test_linear(self, img, shape):
        """Antialiased on downscale like jax.image.resize: 1e-5."""
        ref = np.asarray(j_resize(jnp.asarray(img), shape))
        got = resize(torch.from_numpy(img), shape).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)

    @pytest.mark.parametrize("shape", [(31, 40), (70, 90), (7, 100)])
    @pytest.mark.parametrize("img", [IMG, IMG3], ids=["hw", "hwc"])
    def test_nearest_equal(self, img, shape):
        ref = np.asarray(j_resize(jnp.asarray(img), shape, "nearest"))
        got = resize(torch.from_numpy(img), shape, "nearest").numpy()
        np.testing.assert_array_equal(got, ref)

    def test_percent_and_width(self):
        x, t = jnp.asarray(self.IMG3), torch.from_numpy(self.IMG3)
        np.testing.assert_allclose(resize_percent(t, 62.5).numpy(),
                                   np.asarray(j_resize_percent(x, 62.5)),
                                   atol=1e-5)
        np.testing.assert_allclose(resize_width(t, 40).numpy(),
                                   np.asarray(j_resize_width(x, 40)),
                                   atol=1e-5)

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError, match="method"):
            resize(torch.zeros(4, 4), (2, 2), "cubic")


class TestGray:
    @pytest.mark.parametrize("fn", ["bgr_to_gray", "rgb_to_gray"])
    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_gray(self, fn, dtype):
        img = (RNG.random((20, 30, 3)) * 255).astype(dtype)
        ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(img)))
        got = getattr(tcolor, fn)(torch.from_numpy(img)).numpy()
        assert got.dtype == ref.dtype
        if dtype == np.uint8:
            # a product that lands on .5 may round either way: 1 level there
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
            assert (got == ref).mean() >= 0.999
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)


class TestPng:
    """The port's own 8-bit PNG codec against imageio's."""

    @pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4),
                                       (37, 53, 2)])
    def test_decodes_what_imageio_writes(self, shape):
        """imageio picks per-row filters (Sub, Up, Average, Paeth)."""
        iio = pytest.importorskip("imageio.v3")
        from scipy.ndimage import gaussian_filter

        img = (gaussian_filter(RNG.random(shape), 1.0) * 255).astype(np.uint8)
        data = iio.imwrite("<bytes>", img, extension=".png")
        np.testing.assert_array_equal(png_decode(data), img)

    @pytest.mark.parametrize("shape", [(21, 33), (21, 33, 3), (1, 1), (5, 1, 3)])
    def test_imageio_decodes_what_it_writes(self, shape):
        iio = pytest.importorskip("imageio.v3")
        img = (RNG.random(shape) * 255).astype(np.uint8)
        data = png_encode(img)
        np.testing.assert_array_equal(iio.imread(data, extension=".png"), img)
        np.testing.assert_array_equal(png_decode(data), img)

    def test_imwrite_imread_bgr_round_trip(self, tmp_path):
        bgr = (RNG.random((12, 9, 3)) * 255).astype(np.uint8)
        imwrite(str(tmp_path / "c.png"), bgr)
        np.testing.assert_array_equal(imread(str(tmp_path / "c.png")), bgr)
        gray = bgr[..., 0]
        imwrite(str(tmp_path / "g.png"), gray)
        np.testing.assert_array_equal(imread(str(tmp_path / "g.png")), gray)
        # the JAX package's reader sees the same BGR pixels
        from mav_detection_tpu.data.dataset import imread as jimread

        np.testing.assert_array_equal(jimread(str(tmp_path / "c.png")), bgr)

    def test_rejects_what_it_cannot_read(self):
        with pytest.raises(ValueError, match="not a PNG"):
            png_decode(b"GIF89a" + b"\0" * 20)
        with pytest.raises(ValueError, match="png_encode"):
            png_encode(np.zeros((2, 2, 5), np.uint8))

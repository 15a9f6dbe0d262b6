"""SkyUNet of the port with the shipped weights against the JAX package's,
and ``Dataset.get_sky_segmentation`` without HRNet masks against the JAX
``Dataset``'s.

bf16 tolerance: XLA's CPU convolutions and torch's round bf16 at other
points; measured up to 0.078 logits apart at 64x96 / 60x90 / 120x184 on
two scenes, so the product config is held to 0.25 logits and a mask
agreement of 99.5 %."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from mav_detection_tpu.data.dataset import Dataset as JDataset
from mav_detection_tpu.models import pretrained as j_pretrained
from mav_detection_tpu.models import sky_segmentation as js

from mav_detection_tpu_torch.data.dataset import Dataset, imread, imwrite
from mav_detection_tpu_torch.data.scene import make_scene
from mav_detection_tpu_torch.models import pretrained
from mav_detection_tpu_torch.models import sky_segmentation as ts

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BF16_LOGITS_TOL = 0.25
MASK_AGREEMENT = 0.995


@pytest.fixture(scope="module")
def sky_tree():
    return serialization.msgpack_restore((REPO / "checkpoints" / "sky.msgpack").read_bytes())


@pytest.fixture(scope="module")
def model():
    pretrained.clear_cache()
    return pretrained.load_sky("cpu")


@pytest.fixture
def j_cached(sky_tree, monkeypatch):
    """The JAX loader's cache holding the shipped tree (its own load builds
    a template with ``model.init`` first, half a minute on a CPU)."""
    monkeypatch.setitem(j_pretrained._CACHE, "sky", sky_tree)


def _frame(seed, h, w):
    prev, _, _ = make_scene(seed, h=h, w=w, drone_pos=(w * 0.4, h * 0.3), drone_radius=5)
    return np.stack([prev, (prev * 0.9).astype(np.uint8),
                     np.minimum(prev * 1.1, 255).astype(np.uint8)], -1)


@pytest.mark.parametrize("h,w", [(64, 96), (60, 90)])
def test_logits_match_jax(sky_tree, model, h, w):
    """fp32 within 1e-4 logits, the product bf16 within BF16_LOGITS_TOL, and
    the masks agree; 60x90 goes through the edge padding to 64x96."""
    img = _frame(0, h, w)
    ph, pw = (-h) % 8, (-w) % 8
    padded = jnp.pad(jnp.asarray(img), ((0, ph), (0, pw), (0, 0)), mode="edge")
    ref32 = np.asarray(js.SkyUNet(dtype=jnp.float32).apply(sky_tree, padded))[:h, :w]
    got32 = ts.sky_logits(model, torch.from_numpy(img)[None], torch.float32)[0].numpy()
    np.testing.assert_allclose(got32, ref32, atol=1e-4)
    ref16 = np.asarray(js._sky_apply(sky_tree, padded))[:h, :w]
    got16 = ts.sky_logits(model, torch.from_numpy(img)[None])[0].numpy()
    np.testing.assert_allclose(got16, ref16, atol=BF16_LOGITS_TOL)
    ref_mask = np.asarray(js.sky_mask(sky_tree, jnp.asarray(img)))
    got_mask = ts.sky_mask(model, img, "cpu").numpy()
    assert got_mask.dtype == bool and got_mask.shape == (h, w)
    assert (got_mask == ref_mask).mean() >= MASK_AGREEMENT


def test_sky_mask_refuses_weights_elsewhere():
    with torch.device("meta"):
        elsewhere = ts.SkyUNet()
    with pytest.raises(ValueError, match="weights"):
        ts.sky_mask(elsewhere, _frame(0, 64, 96), "cpu")


def _sequence(base: Path, n: int = 2, h: int = 64, w: int = 96) -> None:
    img_dir = base / "seq" / "images"
    img_dir.mkdir(parents=True)
    for i in range(n):
        imwrite(str(img_dir / f"image_{i:05d}.png"), _frame(i, h, w))


class _Seq(Dataset):
    def get_default_sequence(self):
        return "seq"


class _JSeq(JDataset):
    def get_default_sequence(self):
        return "seq"


def test_dataset_runs_skyunet_without_hrnet_masks(tmp_path, j_cached):
    """No HRNet PNG: both datasets run their SkyUNet; the masks agree, and
    each writes an HRNet-layout PNG that decodes to its mask."""
    _sequence(tmp_path / "port")
    _sequence(tmp_path / "ref")
    ds = _Seq(str(tmp_path / "port"), None, "seq")
    ds.device = "cpu"
    ref_ds = _JSeq(str(tmp_path / "ref"), None, "seq")
    for i in range(ds.N):
        got = ds.get_sky_segmentation(i)
        ref = ref_ds.get_sky_segmentation(i)
        assert got.dtype == bool and got.shape == ref.shape == (64, 96)
        assert (got == ref).mean() >= MASK_AGREEMENT
        assert got[:10].all() and not got[-10:].any()   # the scene's sky band
        png = Path(ds.hrnet_out) / f"image_{i:05d}_prediction.png"
        ref_png = Path(ref_ds.hrnet_out) / f"image_{i:05d}_prediction.png"
        assert png.is_file() and ref_png.is_file()
        vis = imread(str(png))
        np.testing.assert_array_equal((vis[..., 2] == 180) & (vis[..., 1] == 130), got)
        # the reference's PNG of the same mask holds the same pixels
        ref_vis = imread(str(ref_png))
        np.testing.assert_array_equal((ref_vis[..., 2] == 180) & (ref_vis[..., 1] == 130), ref)
        # the second read comes from the cached PNG
        np.testing.assert_array_equal(ds.get_sky_segmentation(i), got)


def test_dataset_without_checkpoint_is_all_false(tmp_path, monkeypatch):
    _sequence(tmp_path / "port", n=1)
    _sequence(tmp_path / "ref", n=1)
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path / "empty"))
    monkeypatch.setattr(j_pretrained, "_CACHE", {})
    pretrained.clear_cache()
    try:
        ds = _Seq(str(tmp_path / "port"), None, "seq")
        ds.device = "cpu"
        got = ds.get_sky_segmentation(0)
        ref = _JSeq(str(tmp_path / "ref"), None, "seq").get_sky_segmentation(0)
    finally:
        pretrained.clear_cache()
    assert not got.any() and not ref.any() and got.shape == ref.shape == (64, 96)
    assert not (Path(ds.hrnet_out) / "image_00000_prediction.png").exists()


def test_dataset_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    _sequence(tmp_path / "port", n=1)
    ds = _Seq(str(tmp_path / "port"), None, "seq")
    with pytest.raises(RuntimeError, match="cuda"):
        ds.get_sky_segmentation(0)


def test_batched_logits_are_the_per_frame_ones(model):
    """Frames of one batch do not mix (per-image statistics)."""
    frames = np.stack([_frame(0, 64, 96), _frame(1, 64, 96)])
    both = ts.sky_logits(model, torch.from_numpy(frames), torch.float32)
    for k in range(2):
        one = ts.sky_logits(model, torch.from_numpy(frames[k:k + 1]), torch.float32)
        np.testing.assert_allclose(both[k].numpy(), one[0].numpy(), atol=1e-5)

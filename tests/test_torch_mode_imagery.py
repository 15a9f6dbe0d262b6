"""Per-mode NN imagery of the port against the JAX package's, and the
per-mode checkpoint resolution (the cases of tests/test_mode_imagery.py, run
on the port).

The FLOW_FOE_YOLO transform fits a RANSAC affine; the tests rebuild JAX's
draws (the host transform's minimal sets ``_sample_minimal_sets(PRNGKey(
seed), 1000, 256, 3)``; the device transform's ``split(key, 3)`` samples) and
feed them to the port. Tolerances: FLOW_UV and FLOW_RADIAL on the host are
bit-equal; FLOW_FOE_YOLO on the host within one grey level (the affine solve
rounds differently in XLA and torch); device images within one grey level
(values landing on a level boundary floor either way) and the residual
magnitude within 1e-3 of 255."""
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.ops.geometry import ransac_fits as j_ransac
from mav_detection_tpu.pipeline import mode_imagery as jm

from mav_detection_tpu_torch.models import pretrained
from mav_detection_tpu_torch.pipeline import mode_imagery as tm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MODES = ("APPEARANCE_RGB", "FLOW_UV", "FLOW_RADIAL", "FLOW_FOE_YOLO")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="module")
def scene(rng):
    """A 64x80 global affine field with a deviating disc, and a frame. The
    disc moves 11 px against the field, so that no affine hypothesis within
    RANSAC's 3 px takes it in whatever the draws."""
    h, w = 64, 80
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    flow = np.stack([0.02 * (xs - 40.0), 0.02 * (ys - 32.0)], -1)
    flow += rng.normal(0, 0.05, flow.shape).astype(np.float32)
    disc = (xs - 20) ** 2 + (ys - 44) ** 2 <= 36
    flow[disc] = (9.0, -7.0)
    frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return frame, flow.astype(np.float32), disc


def _jax_host_sets(seed):
    return np.array(j_ransac._sample_minimal_sets(jax.random.PRNGKey(seed), 1000, 256, 3))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 5])
def test_host_transform_matches_jax(scene, mode, seed):
    frame, flow, _ = scene
    ref = jm.mode_image_host(frame, flow, mode, seed=seed)
    got = tm.mode_image_host(frame, flow, mode, seed=seed,
                             ransac_idx=_jax_host_sets(seed), device="cpu")
    if mode == "APPEARANCE_RGB":
        assert got is frame
        return
    assert got.dtype == np.uint8 and got.shape == np.asarray(ref).shape
    diff = np.abs(got.astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= (1 if mode == "FLOW_FOE_YOLO" else 0), diff.max()


@pytest.mark.parametrize("mode", MODES)
def test_device_transform_matches_jax(scene, mode):
    frame, flow, _ = scene
    h, w = flow.shape[:2]
    gray = frame[..., 0].astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jm.mode_image_device(jnp.asarray(gray), jnp.asarray(flow), mode, key))
    kx, ky, kf = jax.random.split(key, 3)
    sample_yx = np.stack([np.asarray(jax.random.randint(ky, (1000,), 20, h - 20)),
                          np.asarray(jax.random.randint(kx, (1000,), 20, w - 20))], 1)
    idx = np.array(j_ransac._sample_minimal_sets(kf, 1000, 256, 3))
    got = tm.mode_image_device(torch.from_numpy(gray), torch.from_numpy(flow), mode,
                               sample_yx=torch.from_numpy(sample_yx),
                               ransac_idx=torch.from_numpy(idx)).numpy()
    assert got.shape == ref.shape == (h, w, 3) and got.dtype == np.float32
    if mode == "FLOW_FOE_YOLO":
        np.testing.assert_allclose(got, ref, atol=1e-3 * 255)
    else:
        assert np.abs(got - ref).max() <= 1.0


def test_host_draws_its_own_sets_without_jax_ones(scene):
    """Without ``ransac_idx`` the fit draws from a generator seeded with
    ``seed``: repeatable, and close to JAX's own-draw image (the two fits
    take different inlier sets of the noisy background: a mean of at most 2
    grey levels apart, the disc within 3 % of its brightness)."""
    frame, flow, disc = scene
    a = tm.mode_image_host(frame, flow, "FLOW_FOE_YOLO", seed=3, device="cpu")
    b = tm.mode_image_host(frame, flow, "FLOW_FOE_YOLO", seed=3, device="cpu")
    np.testing.assert_array_equal(a, b)
    ref = np.asarray(jm.mode_image_host(frame, flow, "FLOW_FOE_YOLO", seed=3))
    assert np.abs(a.astype(np.int32) - ref.astype(np.int32)).mean() <= 2.0
    np.testing.assert_allclose(a[disc].mean(), ref[disc].mean(), rtol=0.03)


def test_foe_residual_highlights_intruder(scene):
    """A global affine field with a deviating disc: the residual magnitude is
    bright on the disc and dark on the background, on host and device."""
    _, flow, disc = scene
    h, w = flow.shape[:2]
    gen = torch.Generator().manual_seed(1)
    for img in (tm.mode_image_host(np.zeros((h, w, 3), np.uint8), flow, "FLOW_FOE_YOLO",
                                   seed=1, device="cpu"),
                tm.mode_image_device(torch.zeros((h, w)), torch.from_numpy(flow),
                                     "FLOW_FOE_YOLO", generator=gen).numpy()):
        on = float(img[disc].mean())
        off = float(img[~disc].mean())
        assert on > 10 * max(off, 1e-3), (on, off)


def test_appearance_rgb_passthrough(scene):
    frame, flow, _ = scene
    assert tm.mode_image_host(frame, flow, "APPEARANCE_RGB") is frame
    assert tm.mode_image_host(None, flow, "FLOW_UV") is None
    dev = tm.mode_image_device(torch.full(flow.shape[:2], 7.0), torch.from_numpy(flow),
                               "APPEARANCE_RGB")
    assert dev.shape == flow.shape[:2] + (3,)
    assert torch.all(dev == 7.0)


def test_unknown_mode_raises(scene):
    _, flow, _ = scene
    with pytest.raises(ValueError, match="no NN imagery"):
        tm.mode_image_device(torch.zeros(flow.shape[:2]), torch.from_numpy(flow),
                             "FLOW_FOE_CLUSTERING")


def test_foe_yolo_host_runs_on_the_card_by_default(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    frame, flow, _ = scene
    with pytest.raises(RuntimeError, match="cuda"):
        tm.mode_image_host(frame, flow, "FLOW_FOE_YOLO")


# ------------------------------------------------- per-mode checkpoints
@pytest.mark.parametrize("mode,name", [(None, "yolo"), ("APPEARANCE_RGB", "yolo"),
                                       ("FLOW_UV", "yolo_flow_uv"),
                                       ("FLOW_FOE_YOLO", "yolo_flow_foe_yolo")])
def test_name_mapping(mode, name):
    assert pretrained.yolo_checkpoint_name(mode) == name


def test_fallback_to_rgb_weights(tmp_path, monkeypatch, caplog):
    """A mode without a per-mode checkpoint resolves to the RGB-trained file
    with a WARNING; a per-mode file wins; the model cache is keyed by the
    file read, so the two never share an entry; no file at all gives None."""
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    pretrained.clear_cache()
    try:
        assert pretrained.load_yolo_params("FLOW_UV") is None
        assert pretrained.load_yolo("FLOW_UV", "cpu") is None
        shutil.copy(REPO / "checkpoints" / "yolo.msgpack", tmp_path / "yolo.msgpack")
        assert pretrained.resolve_yolo_checkpoint("FLOW_UV") == str(tmp_path / "yolo.msgpack")
        with caplog.at_level(logging.WARNING, logger="mav_detection_tpu_torch"):
            fallback = pretrained.load_yolo("FLOW_UV", "cpu")
        assert "falling back to the RGB-trained weights" in caplog.text
        assert fallback is pretrained.load_yolo(None, "cpu")

        shutil.copy(REPO / "checkpoints" / "yolo_flow_uv.msgpack",
                    tmp_path / "yolo_flow_uv.msgpack")
        assert (pretrained.resolve_yolo_checkpoint("FLOW_UV")
                == str(tmp_path / "yolo_flow_uv.msgpack"))
        per_mode = pretrained.load_yolo("FLOW_UV", "cpu")
        assert per_mode is not fallback
        assert not torch.equal(per_mode.head.weight, fallback.head.weight)
        assert pretrained.load_yolo("FLOW_UV", "cpu") is per_mode
        assert pretrained.load_yolo(None, "cpu") is fallback
    finally:
        pretrained.clear_cache()

"""TinyYOLO of the port with the shipped weights against the JAX package's:
the conversion of the four checkpoints, the raw predictions, the decode with
its greedy suppression, the batch, and detections on the product fixture.

Tolerances: fp32 raw predictions within 1e-4 (measured 6e-6 at 96x128);
the product bf16 within BF16_RAW_TOL (XLA's CPU convolutions and torch's
round bf16 at other points; measured 0.06). Decoded boxes on the same raw
grid: the same ``valid`` and order, ``xywh`` within 1e-3 px and ``score``
within 1e-6 (sigmoid and exp may differ by an ulp between XLA and torch)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.models import yolo as jy
from mav_detection_tpu.pipeline.mode_imagery import mode_image_host as j_mode_image

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.models import checkpoint, pretrained
from mav_detection_tpu_torch.models import yolo as ty

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAMES = ("yolo", "yolo_flow_uv", "yolo_flow_radial", "yolo_flow_foe_yolo")
FP32_RAW_TOL = 1e-4
BF16_RAW_TOL = 0.25
XYWH_TOL, SCORE_TOL = 1e-3, 1e-6


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20240607)


@pytest.fixture(scope="module")
def trees():
    return {n: serialization.msgpack_restore((REPO / "checkpoints" / f"{n}.msgpack").read_bytes())
            for n in NAMES}


@pytest.fixture(scope="module")
def models():
    pretrained.clear_cache()
    return {n: pretrained.load_yolo(None if n == "yolo" else n[len("yolo_"):].upper(), "cpu")
            for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_conversion_of_each_shipped_checkpoint(name, trees):
    """Every Flax leaf of the file lands in TinyYOLO's state_dict, HWIO
    kernels as OIHW, GroupNorm scales as weights, Conv_8 as the head."""
    tree = checkpoint.load_msgpack(str(REPO / "checkpoints" / f"{name}.msgpack"))
    sd = convert.yolo_state_dict_from_flax(tree)
    model = ty.TinyYOLO()
    model.load_state_dict(sd)
    flax = trees[name]["params"]
    assert len(sd) == 2 * (len(flax))
    np.testing.assert_array_equal(sd["stage1.down.weight"].numpy(),
                                  flax["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["stage4.norm2.weight"].numpy(),
                                  flax["GroupNorm_7"]["scale"])
    np.testing.assert_array_equal(sd["head.bias"].numpy(), flax["Conv_8"]["bias"])
    assert tuple(sd["head.weight"].shape) == (15, 192, 1, 1)


def test_conversion_refuses_leftovers_on_either_side():
    path = str(REPO / "checkpoints" / "yolo.msgpack")
    tree = checkpoint.load_msgpack(path)
    tree["params"]["Conv_9"] = {"kernel": np.zeros((1, 1, 15, 15), np.float32)}
    with pytest.raises(ValueError, match="no counterpart"):
        convert.yolo_state_dict_from_flax(tree)
    tree = checkpoint.load_msgpack(path)
    del tree["params"]["GroupNorm_3"]
    with pytest.raises(ValueError, match="missing"):
        convert.yolo_state_dict_from_flax(tree)
    tree = checkpoint.load_msgpack(path)
    tree["params"]["Conv_8"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unexpected Flax leaf"):
        convert.yolo_state_dict_from_flax(tree)


@pytest.mark.parametrize("h,w", [(96, 128), (90, 120)])
def test_raw_predictions_match_jax(trees, models, rng, h, w):
    """fp32 within FP32_RAW_TOL, bf16 within BF16_RAW_TOL; 90x120 goes
    through the edge padding to 96x128."""
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    padded = jnp.pad(jnp.asarray(img), ((0, (-h) % 16), (0, (-w) % 16), (0, 0)),
                     mode="edge")
    x = ty.pad_to_stride(torch.from_numpy(img)[None])
    assert tuple(x.shape[1:3]) == tuple(padded.shape[:2])
    np.testing.assert_array_equal(x[0].numpy(), np.asarray(padded, np.float32))
    tree, model = trees["yolo_flow_uv"], models["yolo_flow_uv"]
    ref32 = np.asarray(jy.TinyYOLO(dtype=jnp.float32).apply(tree, padded))
    with torch.no_grad():
        got32 = model(x, torch.float32)[0].numpy()
        got16 = model(x)[0].numpy()
    assert got32.shape == ref32.shape == (6, 8, 15)
    np.testing.assert_allclose(got32, ref32, atol=FP32_RAW_TOL)
    ref16 = np.asarray(jy.TinyYOLO().apply(tree, padded))
    np.testing.assert_allclose(got16, ref16, atol=BF16_RAW_TOL)


def _crafted(rng):
    """Raw grids (B, gh, gw, 15): (a) every objectness saturated (ties at
    1.0) with tiny disjoint boxes, more than 16 survivors; (b) random scores
    with large overlapping boxes; (c) scores straddling the threshold; (d)
    only the 18 candidates of a 2x3 corner scored, the rest far below."""
    gh, gw = 6, 8
    a = np.zeros((gh, gw, 3, 5), np.float32)
    a[..., 0] = 30.0
    a[..., 3:] = -4.0
    b = rng.normal(0, 2, (gh, gw, 3, 5)).astype(np.float32)
    b[..., 3:] = rng.uniform(1.0, 4.0, (gh, gw, 3, 2))
    c = rng.normal(0, 0.3, (gh, gw, 3, 5)).astype(np.float32)
    c[..., 3:] = rng.uniform(-1.0, 2.0, (gh, gw, 3, 2))
    d = np.zeros((gh, gw, 3, 5), np.float32)
    d[:2, :3] = rng.normal(0, 3, (2, 3, 3, 5))
    d[..., 0] = np.where(np.arange(gw)[None, :, None] < 3, d[..., 0] + 2, -20.0)
    return np.stack([g.reshape(gh, gw, 15) for g in (a, b, c, d)])


def _assert_boxes_equal(got, ref):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.xywh.numpy(), np.asarray(ref.xywh), atol=XYWH_TOL)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), atol=SCORE_TOL)


@pytest.mark.parametrize("threshold", [0.5, 0.0, 0.9])
def test_decode_matches_jax_on_crafted_grids(rng, threshold):
    raw = _crafted(rng)
    got = ty.decode_predictions(torch.from_numpy(raw), score_threshold=threshold)
    n_valid = []
    for i in range(len(raw)):
        ref = jy.decode_predictions(jnp.asarray(raw[i]), score_threshold=threshold)
        _assert_boxes_equal(ty.Boxes(*(t[i] for t in got)), ref)
        n_valid.append(int(np.asarray(ref.valid).sum()))
    if threshold < 0.9:
        assert n_valid[0] == ty.MAX_DETECTIONS      # capped survivors


def test_decode_on_a_small_grid():
    """Fewer than 64 candidates: k is the grid's 18, and the output keeps
    MAX_DETECTIONS rows."""
    raw = np.zeros((2, 3, 15), np.float32)
    raw.reshape(2, 3, 3, 5)[..., 0] = np.arange(18).reshape(2, 3, 3) - 9.0
    got = ty.decode_predictions(torch.from_numpy(raw)[None])
    ref = jy.decode_predictions(jnp.asarray(raw))
    _assert_boxes_equal(ty.Boxes(*(t[0] for t in got)), ref)
    assert got.xywh.shape == (1, ty.MAX_DETECTIONS, 4)


def test_tied_scores_keep_the_lower_index_first():
    raw = np.zeros((4, 4, 3, 5), np.float32)
    raw[..., 0] = 40.0                    # sigmoid == 1.0 exactly in fp32
    raw[..., 3:] = -4.0
    got = ty.decode_predictions(torch.from_numpy(raw.reshape(1, 4, 4, 15)))
    assert torch.sigmoid(torch.tensor(40.0)).item() == 1.0
    # the first 16 cells in row-major anchor order, as top_k gives them
    cells = np.arange(16)
    np.testing.assert_allclose(got.xywh[0, :, 0].numpy(),
                               ((cells // 3) % 4 + 0.5) * 16, atol=1e-4)
    assert got.valid.all()


def test_batch_of_eight_equals_eight_single_calls(models, rng):
    imgs = rng.integers(0, 256, (8, 64, 80, 3)).astype(np.uint8)
    imgs[:, 20:34, 30:44] = 255
    model = models["yolo"]
    batched = ty.detect_boxes(model, imgs, score_threshold=0.0)
    assert batched.xywh.shape == (8, ty.MAX_DETECTIONS, 4)
    for i in range(8):
        single = ty.detect_boxes(model, imgs[i], score_threshold=0.0)
        for a, b in zip(single, batched):
            np.testing.assert_allclose(a.numpy(), b[i].numpy(), atol=1e-5)


def test_create_yolo_draws_from_the_generator():
    a = ty.create_yolo(torch.Generator().manual_seed(3))
    b = ty.create_yolo(torch.Generator().manual_seed(3))
    c = ty.create_yolo()
    torch.testing.assert_close(a.stage2.down.weight, b.stage2.down.weight)
    assert not torch.equal(a.stage2.down.weight, c.stage2.down.weight)
    assert float(a.stage1.norm1.weight.detach().min()) == 1.0
    assert float(a.head.bias.detach().abs().max()) == 0.0
    out = a(torch.zeros((1, 32, 48, 3)), torch.float32)
    assert out.shape == (1, 2, 3, 15)


@pytest.fixture(scope="module")
def product():
    return JSynth()


@pytest.mark.parametrize("mode", ["APPEARANCE_RGB", "FLOW_UV"])
def test_detections_on_the_product_fixture(trees, models, product, mode):
    """The shipped weights on the 240x320 product fixture's mode imagery:
    fp32 gives JAX's kept boxes within XYWH_TOL * 10 px (raw predictions
    agree to ~1e-5, amplified by the exp of the size); the product bf16
    keeps the same number of boxes per frame within one, and the best box
    lies within 2 px of JAX's."""
    name = "yolo" if mode == "APPEARANCE_RGB" else "yolo_flow_uv"
    tree, model = trees[name], models[name]
    for i in (0, 7, 15, 22):
        frame = product.get_frame(i)
        if mode != "APPEARANCE_RGB":
            frame = j_mode_image(frame, np.asarray(product.flows[i], np.float32), mode, seed=i)
        img = jnp.asarray(frame)
        ref = jy.decode_predictions(jy.TinyYOLO(dtype=jnp.float32).apply(tree, img))
        with torch.no_grad():
            raw = model(torch.from_numpy(np.asarray(frame))[None], torch.float32)
        got = ty.decode_predictions(raw)
        got = ty.Boxes(*(t[0] for t in got))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(got.xywh.numpy(), np.asarray(ref.xywh), atol=XYWH_TOL * 10)
        ref16 = jy.detect_boxes(tree, img)
        got16 = ty.detect_boxes(model, frame)
        assert abs(int(got16.valid.sum()) - int(np.asarray(ref16.valid).sum())) <= 1
        if bool(np.asarray(ref16.valid)[0]):
            np.testing.assert_allclose(got16.xywh[0].numpy(), np.asarray(ref16.xywh[0]), atol=2.0)

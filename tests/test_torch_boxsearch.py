"""The port's window search held to the JAX package's, on the cases of
tests/test_boxsearch.py. Boxes and levels must be equal and scores within
1e-4 relative: the two packages take prefix sums in a different order, so
scores differ at fp32 rounding, and these cases have no two windows or moves
that tie to that level."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mav_detection_tpu.ops.geometry import boxsearch as jb

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.ops.geometry import boxsearch as tb


def _blob(h=200, w=300):
    img = np.zeros((h, w), np.float32)
    img[80:130, 150:200] = 10.0
    return img


def _frame_shape():
    """A hollow 90x90 square: no 64x64 window holds more than a corner of
    it, the 96-px window of level 1 holds all of it."""
    img = np.zeros((200, 300), np.float32)
    img[51:141, 99:189] = 5.0
    img[57:135, 105:183] = 0.0
    return img


PYRAMID_CASES = {
    "blob": (_blob(), {}),
    "random_level0": (np.random.default_rng(0).random((128, 160)).astype(np.float32),
                      dict(n_levels=1)),
    "random_pyramid": (np.random.default_rng(1).random((150, 210)).astype(np.float32), {}),
    "coarse_level_wins": (_frame_shape(), {}),
    "all_zero": (np.zeros((100, 120), np.float32), {}),
    "level_smaller_than_window": (_blob(180, 250)[60:140, 120:210], {}),
    "image_smaller_than_window": (np.ones((40, 50), np.float32), {}),
    "three_channels": (np.repeat(_blob()[..., None], 3, -1), {}),
}


@pytest.mark.parametrize("name", sorted(PYRAMID_CASES))
def test_analyze_pyramid_matches_jax(name):
    img, kw = PYRAMID_CASES[name]
    ref = jb.analyze_pyramid(jnp.asarray(img), **kw)
    got = tb.analyze_pyramid(torch.from_numpy(img), **kw)
    np.testing.assert_array_equal(got.box_xywh.numpy(), np.asarray(ref.box_xywh))
    assert int(got.level) == int(ref.level)
    assert float(got.score) == pytest.approx(float(ref.score), rel=1e-4)
    assert got.box_xywh.dtype == torch.float32


def test_analyze_pyramid_edge_results():
    res = tb.analyze_pyramid(torch.zeros(100, 120))
    assert float(res.score) == 0.0 and res.box_xywh.tolist() == [0, 0, 0, 0]
    res = tb.analyze_pyramid(torch.from_numpy(_frame_shape()))
    assert int(res.level) > 0


OPT_CASES = {
    "grows_to_cover_blob": (lambda: np.pad(np.ones((40, 50), np.float32),
                                           ((30, 30), (40, 10))),
                            (50.0, 45.0, 10.0, 10.0)),
    "random_image": (lambda: np.random.default_rng(1).random((40, 40)).astype(np.float32),
                     (10.0, 12.0, 8.0, 9.0)),
    "signed_image": (lambda: (np.random.default_rng(2).normal(size=(60, 70))
                              + np.pad(np.ones((20, 20)), ((20, 20), (25, 25)))
                              ).astype(np.float32),
                     (28.0, 22.0, 10.0, 12.0)),
    "empty_start_box": (lambda: np.ones((30, 30), np.float32), (5.0, 5.0, 0.0, 0.0)),
    "box_at_the_corner": (lambda: np.ones((30, 30), np.float32), (0.0, 0.0, 3.0, 3.0)),
    "all_zero": (lambda: np.zeros((30, 30), np.float32), (5.0, 5.0, 4.0, 4.0)),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimize_window_matches_jax(name):
    make, start = OPT_CASES[name]
    img = make()
    sc_j, box_j = jb.optimize_window(jnp.asarray(img), jnp.asarray(start))
    sc_t, box_t = tb.optimize_window(torch.from_numpy(img), torch.tensor(start))
    np.testing.assert_array_equal(box_t.numpy(), np.asarray(box_j))
    assert float(sc_t) == pytest.approx(float(sc_j), rel=1e-4, abs=1e-4)


def test_optimize_window_stops_at_the_cap_and_at_the_first_flat_step():
    img = np.pad(np.ones((40, 50), np.float32), ((30, 30), (40, 10)))
    start = torch.tensor((50.0, 45.0, 10.0, 10.0))
    sc8, box8 = tb.optimize_window(torch.from_numpy(img), start, max_iters=8)
    sc_j, box_j = jb.optimize_window(jnp.asarray(img), jnp.asarray(start.numpy()),
                                     max_iters=8)
    np.testing.assert_array_equal(box8.numpy(), np.asarray(box_j))
    # a climb that ends long before the cap returns at a sync point with the
    # box it had at its first non-improving step
    sc, box = tb.optimize_window(torch.from_numpy(img), start, max_iters=10_000)
    x, y, w, h = box.tolist()
    assert x <= 41 and x + w >= 89 and y <= 31 and y + h >= 69
    assert float(sc) >= 40 * 50 * 0.95


def test_flow_history_matches_jax():
    """Ring of 3 with 5 pushes: slots overwritten, walked oldest first."""
    rng = np.random.default_rng(3)
    hj = jb.make_flow_history(3, 24, 32)
    ht = tb.make_flow_history(3, 24, 32)
    for _ in range(5):
        flow = (rng.normal(size=(24, 32, 2)) * 1.5).astype(np.float32)
        hj = jb.push_flow(hj, jnp.asarray(flow))
        ht = tb.push_flow(ht, torch.from_numpy(flow))
        assert ht.index == int(hj.index)
        np.testing.assert_array_equal(ht.buffer.numpy(), np.asarray(hj.buffer))
        np.testing.assert_allclose(tb.accumulated_flow(ht).numpy(),
                                   np.asarray(jb.accumulated_flow(hj)), atol=1e-5)
    # the state crosses as numpy both ways
    carried = convert.flow_history_from_reference(
        {k: np.asarray(v) for k, v in hj._asdict().items()})
    np.testing.assert_allclose(tb.accumulated_flow(carried).numpy(),
                               np.asarray(jb.accumulated_flow(hj)), atol=1e-5)
    back = convert.state_to_numpy(ht)
    assert back["buffer"].shape == (3, 24, 32, 2) and int(back["index"]) == ht.index


def test_blockshaped():
    a = np.arange(24.0, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(
        tb.blockshaped(torch.from_numpy(a), 2, 3).numpy(),
        np.asarray(jb.blockshaped(jnp.asarray(a), 2, 3)))
    with pytest.raises(ValueError, match="divisible"):
        tb.blockshaped(torch.zeros(4, 6), 3, 3)

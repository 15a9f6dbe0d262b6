"""RAFT of the port against the JAX package's, function by function and
whole, with the shipped weights (converted by the port from the same
msgpack file the JAX side restores).

Tolerances: the correlation volumes and lookups 1e-5; the fp32 net 1e-3 px.
bf16: XLA's CPU convolutions and torch's round bf16 at other points;
``raft_flow`` at 64x96 was measured 0.034 px (2 iterations) and 0.045 px (6)
apart, so the product config is held to 0.2 px."""
import logging
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from mav_detection_tpu.models import pretrained as j_pretrained
from mav_detection_tpu.models import raft as jr

from mav_detection_tpu_torch.convert import raft_state_dict_from_flax
from mav_detection_tpu_torch.data.scene import make_scene
from mav_detection_tpu_torch.models import raft as tr

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
J32 = jr.RAFTConfig(materialize_corr=False, dtype=jnp.float32)
T32 = tr.RAFTConfig(materialize_corr=False, dtype=torch.float32)
BF16_FLOW_TOL_PX = 0.2


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.fixture(scope="module")
def tree():
    return j_pretrained._migrate_raft_state(serialization.msgpack_restore(
        (REPO / "checkpoints" / "raft.msgpack").read_bytes()))


@pytest.fixture(scope="module")
def model(tree):
    m = tr.RAFT()
    m.load_state_dict(raft_state_dict_from_flax(tree))
    return m


@pytest.fixture(scope="module")
def pair():
    prev, curr, gt = make_scene(0, h=64, w=96, drone_pos=(40.0, 30.0), drone_radius=6)
    return prev, curr, gt


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(2, 0, 1)))[None]


def _hwc(t):
    return t[0].permute(1, 2, 0).detach().numpy()


def _flow_nchw(flow):
    return _nchw(flow)


# ------------------------------------------------------------ encoders
@pytest.mark.parametrize("name,dim", [("fnet", 128), ("cnet", 160)])
def test_encoders_match_jax(tree, model, pair, name, dim):
    x = np.repeat(pair[0][..., None], 3, -1).astype(np.float32) / 127.5 - 1.0
    ref = jr.Encoder(dim, dtype=jnp.float32).apply(
        {"params": tree["params"][name]}, jnp.asarray(x))
    got = getattr(model, name)(_nchw(x), torch.float32)
    assert got.shape == (1, dim, 8, 12)
    np.testing.assert_allclose(_hwc(got), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ correlation forms
def _features(rng, h, w, c=16):
    return (rng.standard_normal((h, w, c)).astype(np.float32),
            rng.standard_normal((h, w, c)).astype(np.float32))


@pytest.mark.parametrize("h,w,mag", [(8, 12, 1.5), (9, 13, 7.0)])
def test_materialised_pyramid_and_lookup_match_jax(rng, h, w, mag):
    f1, f2 = _features(rng, h, w)
    flow = rng.uniform(-mag, mag, (h, w, 2)).astype(np.float32)
    ref_corr = jr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    got_corr = tr.all_pairs_correlation(_nchw(f1), _nchw(f2))
    np.testing.assert_allclose(got_corr[0].numpy(), np.asarray(ref_corr), atol=1e-5)
    ref_pyr = jr.build_corr_pyramid(ref_corr, 4)
    got_pyr = tr.build_corr_pyramid(got_corr, 4)
    for r, g in zip(ref_pyr, got_pyr):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), atol=1e-5)
    ref = jr.lookup_corr(ref_pyr, jnp.asarray(flow), 4)
    got = tr.lookup_corr(got_pyr, _flow_nchw(flow), 4)
    assert got.shape == (1, 4 * 81, h, w)
    np.testing.assert_allclose(_hwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("h,w", [(8, 12), (9, 13)])
def test_feature_pyramid_and_otf_lookup_match_jax(rng, h, w):
    f1, f2 = _features(rng, h, w)
    flow = rng.uniform(-3.0, 3.0, (h, w, 2)).astype(np.float32)
    ref_pyr = jr.build_feature_pyramid(jnp.asarray(f2), 4)
    got_pyr = tr.build_feature_pyramid(_nchw(f2), 4)
    for r, g in zip(ref_pyr, got_pyr):
        np.testing.assert_allclose(_hwc(g), np.asarray(r), atol=1e-6)
    ref = jr.lookup_corr_otf(jnp.asarray(f1), ref_pyr, jnp.asarray(flow), 4)
    got = tr.lookup_corr_otf(_nchw(f1), got_pyr, _flow_nchw(flow), 4)
    np.testing.assert_allclose(_hwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("h,w,max_flow,mag", [(8, 12, 2, 2.0), (9, 13, 2, 9.0),
                                              (9, 13, 4, 4.0), (8, 12, 4, 9.0)])
def test_local_volumes_and_lookup_match_jax(rng, h, w, max_flow, mag):
    """Volumes and their lookup at every level, with the flow inside the
    coverage (|flow| <= max_flow) and past it (saturating alike)."""
    f1, f2 = _features(rng, h, w)
    flow = rng.uniform(-mag, mag, (h, w, 2)).astype(np.float32)
    ref_pyr = jr.build_feature_pyramid(jnp.asarray(f2), 4)
    got_pyr = tr.build_feature_pyramid(_nchw(f2), 4)
    ref_vols = jr.build_local_corr_volumes(jnp.asarray(f1), ref_pyr, 4, max_flow)
    got_vols = tr.build_local_corr_volumes(_nchw(f1), got_pyr, 4, max_flow)
    assert len(got_vols) == 4
    for lvl, (r, g) in enumerate(zip(ref_vols, got_vols)):
        R = tr.local_volume_extent(lvl, 4, max_flow)
        assert g.shape == (1, h, w, 2 * R + 2, 2 * R + 2)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), atol=1e-5)
    ref = jr.lookup_corr_volumes(ref_vols, [p.shape[:2] for p in ref_pyr],
                                 jnp.asarray(flow), 4)
    got = tr.lookup_corr_volumes(got_vols, [tuple(p.shape[-2:]) for p in got_pyr],
                                 _flow_nchw(flow), 4)
    np.testing.assert_allclose(_hwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("h,w", [(8, 12), (9, 13)])
def test_volume_lookup_equals_otf_within_coverage(rng, h, w):
    """The reference's own claim, on the port's functions: within the
    volumes' coverage the lookup is the on-the-fly one."""
    f1, f2 = _features(rng, h, w)
    flow = _flow_nchw(rng.uniform(-2.0, 2.0, (h, w, 2)).astype(np.float32))
    pyr = tr.build_feature_pyramid(_nchw(f2), 4)
    vols = tr.build_local_corr_volumes(_nchw(f1), pyr, 4, 2)
    got = tr.lookup_corr_volumes(vols, [tuple(p.shape[-2:]) for p in pyr], flow, 4)
    ref = tr.lookup_corr_otf(_nchw(f1), pyr, flow, 4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


# ------------------------------------------------------ update operator
def test_gru_and_update_block_match_jax(tree, model, rng):
    h, w = 8, 12
    upd = tree["params"]["refine"]["update"]
    hidden = np.tanh(rng.standard_normal((h, w, 96))).astype(np.float32)
    context = np.maximum(rng.standard_normal((h, w, 64)), 0).astype(np.float32)
    corr = rng.standard_normal((h, w, 324)).astype(np.float32)
    flow = rng.uniform(-2, 2, (h, w, 2)).astype(np.float32)
    x = rng.standard_normal((h, w, 146)).astype(np.float32)
    ref_h = jr.ConvGRU(96, dtype=jnp.float32).apply(
        {"params": upd["ConvGRU_0"]}, jnp.asarray(hidden), jnp.asarray(x))
    got_h = model.update.gru(_nchw(hidden), _nchw(x), torch.float32)
    np.testing.assert_allclose(_hwc(got_h), np.asarray(ref_h), atol=1e-5)
    ref_h, ref_d = jr.UpdateBlock(J32).apply(
        {"params": upd}, jnp.asarray(hidden), jnp.asarray(context),
        jnp.asarray(corr), jnp.asarray(flow))
    got_h, got_d = model.update(_nchw(hidden), _nchw(context), _nchw(corr),
                                _nchw(flow), torch.float32)
    np.testing.assert_allclose(_hwc(got_h), np.asarray(ref_h), atol=1e-5)
    np.testing.assert_allclose(_hwc(got_d), np.asarray(ref_d), atol=1e-5)


def test_convex_upsample_matches_jax(rng):
    h, w = 5, 7
    flow = rng.uniform(-3, 3, (h, w, 2)).astype(np.float32)
    mask = rng.standard_normal((h, w, 576)).astype(np.float32) * 3
    ref = jr.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    got = tr.convex_upsample(_nchw(flow), _nchw(mask))
    assert got.shape == (1, 2, 8 * h, 8 * w)
    np.testing.assert_allclose(_hwc(got), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------ whole net
@pytest.mark.parametrize("iters", [2, 6])
def test_raft_flow_matches_jax(tree, model, pair, iters):
    prev, curr, _ = pair
    ref32 = np.asarray(jr.raft_flow(tree, jnp.asarray(prev), jnp.asarray(curr), iters, J32))
    got32 = tr.raft_flow(model, torch.from_numpy(prev)[None],
                         torch.from_numpy(curr)[None], iters, T32)[0].numpy()
    assert got32.shape == (64, 96, 2)
    np.testing.assert_allclose(got32, ref32, atol=1e-3)
    ref16 = np.asarray(jr.raft_flow(tree, jnp.asarray(prev), jnp.asarray(curr), iters))
    got16 = tr.raft_flow(model, torch.from_numpy(prev)[None],
                         torch.from_numpy(curr)[None], iters)[0].numpy()
    np.testing.assert_allclose(got16, ref16, atol=BF16_FLOW_TOL_PX)


def test_raft_flow_pads_odd_sizes_and_takes_rgb(model, pair):
    """A 60x90 pair runs padded to 64x96 and crops back; an RGB frame
    with equal channels is the gray one."""
    prev, curr, _ = pair
    p, c = torch.from_numpy(prev[:60, :90])[None], torch.from_numpy(curr[:60, :90])[None]
    gray = tr.raft_flow(model, p, c, 2, T32)
    rgb = tr.raft_flow(model, p[..., None].expand(1, 60, 90, 3),
                       c[..., None].expand(1, 60, 90, 3), 2, T32)
    assert gray.shape == (1, 60, 90, 2) and torch.equal(gray, rgb)


def test_video_matches_the_pair_path(model):
    frames = np.stack([make_scene(k, h=64, w=96)[0] for k in range(3)])
    video = tr.raft_flow_video(frames, model, 2, T32, device="cpu")
    pairs = tr.raft_flow_batch(frames[:-1], frames[1:], model, 2, T32, device="cpu")
    assert video.shape == (2, 64, 96, 2)
    np.testing.assert_allclose(video.numpy(), pairs.numpy(), atol=1e-4)


def test_materialised_config_runs_the_whole_net(model, pair):
    """The ladder's last rung: the all-pairs volume gives the banded
    volumes' flow where the motion lies inside their coverage (its lookup is
    held to JAX's above; XLA's CPU compile of the whole net with it takes
    the better part of a minute)."""
    prev, curr, _ = pair
    args = (model, torch.from_numpy(prev)[None], torch.from_numpy(curr)[None], 2)
    got = tr.raft_flow(*args, replace(T32, materialize_corr=True))[0].numpy()
    banded = tr.raft_flow(*args, T32)[0].numpy()
    assert np.abs(banded).max() < 8.0
    np.testing.assert_allclose(got, banded, atol=1e-3)


def test_other_architecture_is_refused(model, pair):
    prev, curr, _ = pair
    with pytest.raises(ValueError, match="hidden_dim"):
        tr.raft_flow(model, torch.from_numpy(prev)[None], torch.from_numpy(curr)[None],
                     2, replace(T32, hidden_dim=64))


# ------------------------------------------------ operating points, ladder
def _ladder(esc, cfg, hw):
    out = []
    while cfg is not None and len(out) < 12:
        out.append((cfg.max_flow_lookup, cfg.materialize_corr))
        cfg = esc(cfg, hw)
    return out


@pytest.mark.parametrize("hw", [(64, 96), (240, 320), (480, 752), (256, 480),
                                (1024, 1920), (120, 4000), (40, 40)])
@pytest.mark.parametrize("max_flow", [1, 2, 5])
def test_escalation_ladder_matches_jax(hw, max_flow):
    ref = _ladder(jr._escalate_config, replace(jr.INFERENCE_CONFIG,
                                               max_flow_lookup=max_flow), hw)
    got = _ladder(tr._escalate_config, replace(tr.INFERENCE_CONFIG,
                                               max_flow_lookup=max_flow), hw)
    assert got == ref
    assert tr._escalate_config(replace(tr.INFERENCE_CONFIG, materialize_corr=True), hw) is None


def test_materialize_budget_is_read_from_the_environment():
    assert tr._MATERIALIZE_BUDGET_BYTES == jr._MATERIALIZE_BUDGET_BYTES


@pytest.mark.parametrize("hw", [(64, 96), (480, 752), (481, 752), (1024, 1920), (600, 800)])
def test_tuned_operating_points_match_jax(hw):
    ref, got = jr.tuned_raft_config(*hw), tr.tuned_raft_config(*hw)
    assert (got.scale, got.iters) == (ref.scale, ref.iters)
    assert (got.config.max_flow_lookup, got.config.materialize_corr) == \
        (ref.config.max_flow_lookup, ref.config.materialize_corr)
    assert tr.flow_coverage_px(got.config) == jr.flow_coverage_px(ref.config)


def test_tuned_batch_at_quarter_scale_matches_jax(tree, model):
    """256x384 pairs through TunedRAFT(scale=4): downscaled to 64x96,
    inferred, upsampled x4; fp32 configs on both sides."""
    frames = np.stack([make_scene(k, h=256, w=384)[0] for k in range(2)])
    imgs1, imgs2 = frames[:1], frames[1:]
    ref = np.asarray(jr.raft_flow_batch_tuned(
        jnp.asarray(imgs1), jnp.asarray(imgs2), tree,
        tuned=jr.TunedRAFT(scale=4, iters=2, config=J32)))
    got = tr.raft_flow_batch_tuned(imgs1, imgs2, model,
                                   tuned=tr.TunedRAFT(scale=4, iters=2, config=T32),
                                   device="cpu").numpy()
    assert got.shape == ref.shape == (1, 256, 384, 2)
    np.testing.assert_allclose(got, ref, atol=4e-3)


# ------------------------------------------------------------ saturation
@pytest.mark.parametrize("scale", [0.5, 5.0, 14.0, 14.4, 16.0, 40.0])
def test_saturation_check_matches_reference_unpadded(rng, scale):
    flow = (rng.standard_normal((3, 20, 30, 2)) * scale).astype(np.float32)
    for q in (0.5, 0.9, 0.99):
        ref = float(np.quantile(np.linalg.norm(flow, axis=-1), q))
        assert tr.flow_magnitude_quantile(torch.from_numpy(flow), q) == pytest.approx(ref, rel=1e-6)
    assert tr.check_flow_saturation(torch.from_numpy(flow)) == \
        jr.check_flow_saturation(flow)
    mat = replace(tr.INFERENCE_CONFIG, materialize_corr=True)
    assert tr.check_flow_saturation(torch.from_numpy(flow), mat) is False


def test_padded_tail_escalates_on_its_real_lanes(rng):
    """A tail batch of 1 real pair padded to 8 with the last frame against
    itself: 5 % of the real lane moves 15 px (past 0.9 x 16 px), the pad
    lanes are still. The reference's p99 over all 8 lanes sees 0.6 %
    saturated pixels and does not escalate; the port's, over the real lane,
    does."""
    flow = np.zeros((8, 40, 50, 2), np.float32)
    flow[0, ..., 0] = 1.0
    flow[0, :2, :, 0] = 15.0                      # 100 of 2000 pixels
    assert jr.check_flow_saturation(flow) is False
    assert tr.check_flow_saturation(torch.from_numpy(flow)) is False
    assert tr.check_flow_saturation(torch.from_numpy(flow), n_real=1) is True

    seen = []

    def run(cfg):
        seen.append(cfg)
        out = torch.from_numpy(flow).clone()
        if cfg.max_flow_lookup > 2 or cfg.materialize_corr:
            out[0, :2] = 1.0                      # the wider volume resolves it
        return out

    tr._flow_with_escalation(run, (320, 400), tr.INFERENCE_CONFIG, n_real=1)
    assert [(c.max_flow_lookup, c.materialize_corr) for c in seen] == [(2, False), (4, False)]
    seen.clear()
    tr._flow_with_escalation(run, (320, 400), tr.INFERENCE_CONFIG)
    assert len(seen) == 1                         # every lane counted: diluted


def test_exhausted_ladder_keeps_the_widest_estimate(caplog):
    calls = []

    def run(cfg):
        calls.append(cfg)
        return torch.full((1, 16, 16, 2), 30.0)

    with caplog.at_level(logging.WARNING, logger="mav_detection_tpu_torch"):
        out = tr._flow_with_escalation(run, (16, 16), tr.INFERENCE_CONFIG)
    assert out.shape == (1, 16, 16, 2)
    assert [(c.max_flow_lookup, c.materialize_corr) for c in calls] == \
        _ladder(tr._escalate_config, tr.INFERENCE_CONFIG, (16, 16))
    assert "ladder exhausted" in caplog.text


# ------------------------------------------------------------ fallback
def test_default_params_are_seeded_and_warn(caplog):
    with caplog.at_level(logging.WARNING, logger="mav_detection_tpu_torch"):
        a = tr._default_params("cpu", torch.Generator().manual_seed(1))
    assert "no RAFT checkpoint" in caplog.text
    b = tr._default_params("cpu", torch.Generator().manual_seed(1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert tr._default_params("cpu") is tr._default_params("cpu")


def test_entry_points_fall_back_to_random_weights(tmp_path, monkeypatch):
    from mav_detection_tpu_torch.models import pretrained

    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    pretrained.clear_cache()
    try:
        frames = np.zeros((2, 64, 64), np.uint8)
        flow = tr.raft_flow_batch(frames[:1], frames[1:], iters=1, device="cpu")
    finally:
        pretrained.clear_cache()
    assert flow.shape == (1, 64, 64, 2) and torch.isfinite(flow).all()

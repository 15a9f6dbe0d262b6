"""Two steps of each trainer of the port (``mav_detection_tpu_torch.cli.train``)
against the JAX package's ``run_chunk`` on the same scenes, on the CPU.

The reference's chunk loop (`_scan_chunks`) is replaced here by one that calls its
``run_chunk`` once for every step and hands back what it was given (the
initial parameters and the PRNG key), so the port starts from the same
parameters and renders the same scenes: the draws of each step's keys,
split as the reference's chunk body splits them, go in as ``SceneDraws``.
The nets run in fp32 on both sides (the reference's sky and TinyYOLO
trainers build bf16 nets; their constructors are swapped for fp32 ones here).
The first update runs at learning rate 0 (optax's schedule at count 0), so
two steps are one real update after the clip and Adam's moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mav_detection_tpu.cli import train as jtrain
from mav_detection_tpu.models import raft as jraft
from mav_detection_tpu.models import sky_segmentation as jsky
from mav_detection_tpu.models import yolo as jyolo
from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.cli import train as ttrain
from mav_detection_tpu_torch.models import raft as traft
from torch_train_helpers import port_draws

torch.set_num_threads(1)

HW = (32, 48)
BATCH = 2
STEPS = 2
# losses: 1e-4 relative. The reference renders its scenes under vmap, which
# reassociates the texture reductions (~0.05 grey levels off the port's,
# tests/test_synthgen.py says so of the reference itself), so the gradients
# differ by ~1e-4 relative, and a max-pool or relu whose inputs nearly tie
# may route a gradient the other way. Adam then divides each moment by its
# own magnitude: where the two steps' gradients nearly cancel, where a
# gradient is rounding noise (a conv bias followed by GroupNorm has a
# gradient of exactly 0 in exact arithmetic) or where a route flipped, the
# update differs by a large part of a step. So the parameters are held by
# their distribution, in units of one step of the peak learning rate: the
# median difference within 0.1 % of a step and the 99th percentile within
# 10 % (measured: median 0.0006 / 0.00002 / 0.00001 and 99th percentile
# 0.028 / 0.0003 / 0.00002 of a step for sky / RAFT / TinyYOLO). A wrong
# gradient, clip or schedule moves most parameters by whole steps.
LOSS_RTOL = 1e-4
MEDIAN_STEPS = 1e-3
P99_STEPS = 0.1
TINY = dict(feature_dim=32, hidden_dim=32, context_dim=32, corr_levels=2,
            corr_radius=1, iters=2)


def _reference(monkeypatch, fn, **kw):
    got = {}

    def run_once(run_chunk, params, opt_state, key, steps, chunk, label, **_):
        got["init"], got["key"] = jax.device_get(params), key
        p, _, _, losses = run_chunk(params, opt_state, key, steps)
        return p, np.asarray(losses)

    monkeypatch.setattr(jtrain, "_scan_chunks", run_once)
    params, losses = fn(**kw)
    return got, jax.device_get(params), losses


def _step_keys(key, steps, batch, three_way):
    """Per step, the scene keys of the reference's chunk body."""
    out = []
    for _ in range(steps):
        if three_way:
            key, sub, _ = jax.random.split(key, 3)
        else:
            key, sub = jax.random.split(key)
        out.append(jax.random.split(sub, batch))
    return out


def _compare(model, ref_params, to_state_dict, losses, ref_losses, peak_lr, **kw):
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    ref = to_state_dict(ref_params, **kw)
    got = model.state_dict()
    assert set(got) == set(ref)
    diff = np.concatenate([np.abs(got[k].numpy() - v.numpy()).ravel() / peak_lr
                           for k, v in ref.items()])
    assert np.median(diff) < MEDIAN_STEPS, np.median(diff)
    assert np.percentile(diff, 99) < P99_STEPS, np.percentile(diff, 99)


def test_train_raft_matches_run_chunk(monkeypatch):
    cfg = jraft.RAFTConfig(**TINY, dtype=jnp.float32)
    got, ref_params, ref_losses = _reference(
        monkeypatch, jtrain.train_raft, steps=STEPS, batch=BATCH, hw=HW, iters=2,
        chunk=STEPS, seed=7, config=cfg, use_selector=False)
    keys = _step_keys(got["key"], STEPS, BATCH, False)
    tcfg = traft.RAFTConfig(**TINY, dtype=torch.float32)
    model, losses = ttrain.train_raft(
        steps=STEPS, batch=BATCH, hw=HW, iters=2, chunk=STEPS, seed=7, config=tcfg,
        use_selector=False, device="cpu",
        init_params=convert.raft_state_dict_from_flax(got["init"], tcfg),
        draws=lambda step: port_draws(keys[step], *HW))
    _compare(model, ref_params, convert.raft_state_dict_from_flax, losses, ref_losses,
             2.5e-4, config=tcfg)


def test_train_sky_matches_run_chunk(monkeypatch):
    def create_fp32(key=None, image_hw=(256, 384)):
        model = jsky.SkyUNet(dtype=jnp.float32)
        return model, model.init(key, jnp.zeros(image_hw + (3,), jnp.float32))

    monkeypatch.setattr(jsky, "create_sky_model", create_fp32)
    got, ref_params, ref_losses = _reference(
        monkeypatch, jtrain.train_sky, steps=STEPS, batch=BATCH, hw=HW, chunk=STEPS,
        seed=3)
    keys = _step_keys(got["key"], STEPS, BATCH, False)
    model, losses = ttrain.train_sky(
        steps=STEPS, batch=BATCH, hw=HW, chunk=STEPS, seed=3, use_selector=False,
        device="cpu", dtype=torch.float32,
        init_params=convert.sky_state_dict_from_flax(got["init"]),
        draws=lambda step: port_draws(keys[step], *HW))
    _compare(model, ref_params, convert.sky_state_dict_from_flax, losses, ref_losses, 1e-3)


@pytest.mark.parametrize("mode", ["APPEARANCE_RGB", "FLOW_UV"])
def test_train_yolo_matches_run_chunk(monkeypatch, mode):
    def create_fp32(key=None, image_hw=(480, 752)):
        model = jyolo.TinyYOLO(dtype=jnp.float32)
        h = image_hw[0] + (-image_hw[0]) % 16
        w = image_hw[1] + (-image_hw[1]) % 16
        return model, model.init(key, jnp.zeros((h, w, 3), jnp.float32))

    monkeypatch.setattr(jyolo, "create_yolo", create_fp32)
    got, ref_params, ref_losses = _reference(
        monkeypatch, jtrain.train_yolo, steps=STEPS, batch=BATCH, hw=HW, chunk=STEPS,
        seed=5, mode=mode)
    keys = _step_keys(got["key"], STEPS, BATCH, True)
    model, losses = ttrain.train_yolo(
        steps=STEPS, batch=BATCH, hw=HW, chunk=STEPS, seed=5, mode=mode,
        use_selector=False, device="cpu", dtype=torch.float32,
        init_params=convert.yolo_state_dict_from_flax(got["init"]),
        draws=lambda step: port_draws(keys[step], *HW))
    _compare(model, ref_params, convert.yolo_state_dict_from_flax, losses, ref_losses,
             1e-3)

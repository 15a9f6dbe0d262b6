"""``cli.train --model raft --devices N`` in the port: RAFT data parallel over
spawned gloo ranks, held to the port's one-device trainer and to the JAX
package's data-parallel trainer (``mav_detection_tpu.cli.train.train_raft``
with ``devices=2`` on its virtual CPU mesh) on the same scene draws.

Every rank draws the whole batch's scenes and renders its slice; the
gradients are averaged with one all-reduce before the global-norm clip. So a
step equals the one-device step up to the order of the batch mean's sums.
Gate: the reference's own for its data-parallel trainer, ``rtol=2e-2,
atol=1e-3`` on the parameters after 2 steps (its TestMultiDeviceTraining),
the losses within 1e-4 relative (tests/test_torch_train_steps.py's). The
warmup makes step 0's rate 0, so the 2 steps move a weight by 2.5e-4 at
most, below that atol, and both losses are taken before the one real
update. So the parameter change (final minus initial) is held too, tensor by
tensor against its norm: 1e-4 against the port's one-device run (the sound
run: 3.8e-6) and 1e-2 against the JAX trainer (2.3e-3; another convolution
order, and Adam's near-zero gradients). Dropping the gradient all-reduce
gives each rank its half-batch update, and a rank that never steps has no
change at all: both fail these limits by far.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.cli import train as jtrain
from mav_detection_tpu.models import raft as jraft

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.cli import train as ttrain
from mav_detection_tpu_torch.models import raft as traft
from torch_train_helpers import port_draws

torch.set_num_threads(1)

HW = (32, 48)
BATCH = 4
STEPS = 2
TINY = dict(feature_dim=32, hidden_dim=32, context_dim=32, corr_levels=2,
            corr_radius=1, iters=2)


def _reference(monkeypatch, devices):
    """The JAX trainer's result with its chunk scan run once, and the
    initial weights and key it started from."""
    got = {}

    def run_once(run_chunk, params, opt_state, key, steps, chunk, label, **_):
        got["init"], got["key"] = jax.device_get(params), key
        p, _, _, losses = run_chunk(params, opt_state, key, steps)
        return p, np.asarray(losses)

    monkeypatch.setattr(jtrain, "_scan_chunks", run_once)
    params, losses = jtrain.train_raft(
        steps=STEPS, batch=BATCH, hw=HW, iters=2, chunk=STEPS, seed=7,
        config=jraft.RAFTConfig(**TINY, dtype=jnp.float32), use_selector=False,
        devices=devices)
    return got, jax.device_get(params), losses


def _step_keys(key, steps, batch):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax.random.split(sub, batch))
    return out


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        got, ref_params, ref_losses = _reference(mp, devices=2)
    finally:
        mp.undo()
    keys = _step_keys(got["key"], STEPS, BATCH)
    tcfg = traft.RAFTConfig(**TINY, dtype=torch.float32)
    init = convert.raft_state_dict_from_flax(got["init"], tcfg)
    kw = dict(steps=STEPS, batch=BATCH, hw=HW, iters=2, chunk=STEPS, seed=7,
              config=tcfg, use_selector=False, device="cpu", init_params=init,
              draws=lambda step: port_draws(keys[step], *HW))
    one = ttrain.train_raft(**kw)
    two = ttrain.train_raft(devices=2, **kw)
    ref = convert.raft_state_dict_from_flax(ref_params, tcfg)
    return dict(one=one, two=two, ref=ref, ref_losses=ref_losses, init=init)


def _assert_params_close(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-2, atol=1e-3,
                                   err_msg=k)


def _assert_changes_close(got, ref, init, rel):
    """The change each step made, tensor by tensor: |got - ref| of the
    change within ``rel`` of the reference change's norm."""
    moved = 0
    for k, v in init.items():
        want = (ref[k] - v).double()
        err = float(((got[k] - v).double() - want).norm())
        assert err <= rel * float(want.norm()), (k, err, float(want.norm()))
        moved += float(want.norm()) > 0
    assert moved > len(init) // 2      # the comparison is not of unchanged weights


def test_data_parallel_matches_one_device(runs):
    (m1, l1), (m2, l2) = runs["one"], runs["two"]
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    _assert_params_close(m2.state_dict(), m1.state_dict())
    _assert_changes_close(m2.state_dict(), m1.state_dict(), runs["init"], 1e-4)


def test_data_parallel_matches_jax_data_parallel(runs):
    m2, l2 = runs["two"]
    np.testing.assert_allclose(l2, runs["ref_losses"], rtol=1e-4)
    _assert_params_close(m2.state_dict(), runs["ref"])
    _assert_changes_close(m2.state_dict(), runs["ref"], runs["init"], 1e-2)


def test_weights_come_back_on_the_callers_device(runs):
    model, losses = runs["two"]
    assert next(model.parameters()).device.type == "cpu"
    assert losses.shape == (STEPS,) and np.isfinite(losses).all()


@pytest.mark.parametrize("devices,batch,device,match", [
    (16, 3, "cpu", "--devices 16 > 8 available devices"),
    (2, 3, "cpu", "--batch 3 must divide by --devices 2"),
    (2, 8, "cuda", "--devices 2 > 0 available devices"),
])
def test_check_devices_keeps_the_reference_order_and_words(monkeypatch, devices,
                                                            batch, device, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match=match):
        ttrain._check_devices(devices, batch, device)
    ttrain._check_devices(1, 3, device)     # one device: nothing to check


def test_cli_passes_devices_to_the_trainer(monkeypatch):
    seen = {}

    def fake_train_raft(**kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(ttrain, "train_raft", fake_train_raft)
    with pytest.raises(SystemExit):
        ttrain.main(["--model", "raft", "--devices", "2", "--device", "cpu",
                     "--batch", "4", "--steps", "2"])
    assert seen["devices"] == 2 and seen["device"] == torch.device("cpu")

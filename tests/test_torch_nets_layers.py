"""The port's Flax-equivalent layers (``models/layers.py``) against
``flax.linen.Conv`` / ``GroupNorm`` on random params, fp32 within 1e-5."""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mav_detection_tpu_torch.models.layers import Conv, GroupNorm, init_params, same_pads

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(1016)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(2, 0, 1)))[None]


def _hwc(t):
    return t[0].permute(1, 2, 0).detach().numpy()


@pytest.mark.parametrize("n,k,s,pads", [(16, 7, 2, (2, 3)), (15, 7, 2, (3, 3)),
                                        (16, 3, 2, (0, 1)), (15, 3, 2, (1, 1)),
                                        (16, 3, 1, (1, 1)), (16, 1, 2, (0, 0)),
                                        (16, 7, 1, (3, 3))])
def test_same_pads_are_xla_s(n, k, s, pads):
    assert same_pads(n, k, s) == pads


@pytest.mark.parametrize("h,w", [(16, 24), (15, 23)])
@pytest.mark.parametrize("k,s", [(7, 2), (3, 2), (3, 1), (1, 2), (1, 1), (7, 1)])
def test_conv_matches_flax(rng, h, w, k, s):
    cin, cout = 5, 7
    x = rng.standard_normal((h, w, cin)).astype(np.float32)
    kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.3
    bias = rng.standard_normal(cout).astype(np.float32)
    ref = fnn.Conv(cout, (k, k), strides=(s, s), dtype=jnp.float32).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    conv = Conv(cin, cout, k, s)
    conv.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(bias)})
    got = _hwc(conv(_nchw(x), torch.float32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_conv_bf16_casts_input_weights_and_output(rng):
    """``dtype=bf16``: bf16 in, bf16 out; within bf16 rounding of Flax's."""
    x = rng.standard_normal((12, 12, 4)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3
    bias = rng.standard_normal(6).astype(np.float32)
    ref = fnn.Conv(6, (3, 3), dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    conv = Conv(4, 6, 3)
    conv.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(bias)})
    got = conv(_nchw(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_hwc(got.float()), np.asarray(ref, np.float32),
                               atol=0.05, rtol=0.02)


@pytest.mark.parametrize("groups,c", [(8, 48), (8, 24), (8, 8), (4, 12)])
@pytest.mark.parametrize("h,w", [(6, 10), (1, 7)])
def test_groupnorm_matches_flax_per_row(rng, groups, c, h, w):
    """On one unbatched (h, w, c) image, as the reference's nets apply it,
    Flax normalises each row over w and the group's channels."""
    x = (rng.standard_normal((h, w, c)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias}}
    ref = fnn.GroupNorm(num_groups=groups, dtype=jnp.float32).apply(params, jnp.asarray(x))
    gn = GroupNorm(groups, c)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = _hwc(gn(_nchw(x), torch.float32))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)
    # and per image of a batch, as under jax.vmap
    xb = np.stack([x, x[::-1] * 0.5])
    refb = jax.vmap(lambda a: fnn.GroupNorm(num_groups=groups).apply(params, a))(
        jnp.asarray(xb))
    gotb = gn(torch.from_numpy(xb.transpose(0, 3, 1, 2).copy()), torch.float32)
    np.testing.assert_allclose(gotb.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(refb), atol=1e-5, rtol=1e-5)


def test_groupnorm_bf16_statistics_in_fp32(rng):
    x = (rng.standard_normal((4, 9, 16)) * 50 + 100).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    params = {"params": {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}}
    ref = fnn.GroupNorm(num_groups=8, dtype=jnp.bfloat16).apply(params, xb)
    gn = GroupNorm(8, 16)
    init_params(gn, None)
    got = gn(_nchw(np.asarray(xb, np.float32)).to(torch.bfloat16), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_hwc(got.float()), np.asarray(ref, np.float32),
                               atol=0.02, rtol=0.01)


def test_init_params_is_flax_s_scheme():
    conv, gn = Conv(16, 32, 3), GroupNorm(8, 32)
    g = torch.Generator().manual_seed(0)
    init_params(conv, g)
    init_params(gn, g)
    std = float(conv.weight.detach().std())
    assert abs(std - (1.0 / (16 * 9)) ** 0.5) < 0.01
    assert float(conv.weight.detach().abs().max()) <= 2 * (1.0 / (16 * 9)) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(conv.bias, torch.zeros(32))
    assert torch.equal(gn.weight, torch.ones(32)) and torch.equal(gn.bias, torch.zeros(32))
    conv2 = Conv(16, 32, 3)
    init_params(conv2, torch.Generator().manual_seed(0))
    assert torch.equal(conv.weight, conv2.weight)

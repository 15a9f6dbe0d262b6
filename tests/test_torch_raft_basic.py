"""The published RAFT in the port (``models.raft.BasicRAFT(RAFT_BASIC)``) against
the benchmark's plain float32 reference (``h100_bench/reference/
raft_basic.py``) on the CPU, with the reference's seeded weights loaded under
the published names: block by block, whole, in bf16, through the
Processor's RAFT route, its spans, and its operation count. 64x96 frames
(the 1/8 map 8x12, its coarsest level 1x1), b=2."""
from __future__ import annotations

import json
import logging
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from h100_bench import raft_roofline, scene
from h100_bench.reference import raft_basic as ref
from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.models import raft as R
from mav_detection_tpu_torch.models.layers import BatchNorm, Conv2d, conv_flops
from mav_detection_tpu_torch.pipeline.processor import Processor
from mav_detection_tpu_torch.utils.tracing import Tracer, recording

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "h100_bench" / "configs"
                     / "midgard-752x480-raft.json").read_text())
H, W, B = 64, 96, 2
SEED = 2 ** 31 + 5
FP32 = replace(R.RAFT_BASIC, dtype=torch.float32)
# float32 against float32, the same operations in the same order on one
# device: only the convolutions' summation order may differ, ~1e-6 relative
BLOCK_TOL = 1e-4
# the acceptance bound of the whole fp32 flow, in px (measured ~1e-6)
FP32_EPE_PX = 1e-4
# bf16 convolutions (8 mantissa bits; the flow and mask heads among them)
# over 12 GRU iterations against the fp32 reference: 0.017-0.020 px mean
# end-point error measured at this size, where the flow averages ~2 px;
# about twice and a half that
BF16_EPE_PX = 0.05


def _epe(a, b):
    return torch.linalg.vector_norm(a - b, dim=-1).mean(dim=(1, 2))


@pytest.fixture(scope="module")
def weights():
    return ref.weights(CONFIG, SEED, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    m = R.BasicRAFT(R.RAFT_BASIC)
    m.load_state_dict(weights, strict=True)
    return m


@pytest.fixture(scope="module")
def frames():
    sc = scene.render(dict(CONFIG["scene"], height=H, width=W, max_flow_px=3.0),
                      B + 1, SEED, "cpu")
    return sc["gray"][:B], sc["gray"][1:]


@pytest.fixture(scope="module")
def ref_flow(frames, weights):
    return ref.flow(*frames, CONFIG, weights)


def test_state_dict_loads_strictly_under_the_published_names(model, weights):
    """(d) The reference's dict loads with ``strict=True``; every width is
    RAFT_BASIC's and the configuration's; the port's own initialiser draws
    the same tensors from the same seed."""
    sd = model.state_dict()
    assert set(sd) == set(weights)
    for k in ("fnet.conv1.weight", "cnet.norm1.running_var", "fnet.layer2.0.downsample.0.weight",
              "cnet.layer3.0.downsample.1.num_batches_tracked", "update_block.encoder.convc1.weight",
              "update_block.gru.convz1.weight", "update_block.flow_head.conv1.weight",
              "update_block.mask.0.weight", "update_block.mask.2.bias"):
        assert k in sd, k
    raft = CONFIG["raft"]
    for k in ("feature_dim", "hidden_dim", "context_dim", "corr_levels",
              "corr_radius", "iters", "materialize_corr"):
        assert getattr(R.RAFT_BASIC, k) == raft[k], k
    assert R.RAFT_BASIC.dtype == torch.bfloat16
    assert sd["fnet.conv2.weight"].shape == (256, 128, 1, 1)
    assert sd["cnet.conv2.weight"].shape == (128 + 128, 128, 1, 1)
    assert sd["update_block.encoder.convc1.weight"].shape == (256, 4 * 81, 1, 1)
    assert sd["update_block.gru.convz1.weight"].shape == (128, 384, 1, 5)
    assert sd["update_block.gru.convq2.weight"].shape == (128, 384, 5, 1)
    assert sd["update_block.flow_head.conv1.weight"].shape == (256, 128, 3, 3)
    assert sd["update_block.mask.2.weight"].shape == (576, 256, 1, 1)
    assert sum(p.numel() for p in model.parameters()) == 5_257_536
    own = R.create_basic_raft(torch.Generator().manual_seed(SEED)).state_dict()
    assert all(torch.equal(own[k], weights[k]) for k in weights)
    other = ref.weights(CONFIG, SEED + 1, "cpu")
    assert not torch.equal(other["fnet.conv1.weight"], weights["fnet.conv1.weight"])


@pytest.mark.parametrize("k, stride", [(7, 2), (3, 2), (1, 2), (3, 1), ((1, 5), 1), ((5, 1), 1)])
def test_conv2d_pads_as_the_published_conv(k, stride):
    """(a) ``Conv2d`` is ``nn.Conv2d(padding=k // 2)``: 3 rows before and 3
    after a 7x7 at stride 2 (XLA's SAME would put 2 and 3), and the 1x5 /
    5x1 kernels of ``SepConvGRU``."""
    g = torch.Generator().manual_seed(1)
    ours = Conv2d(5, 4, k, stride)
    kh, kw = (k, k) if isinstance(k, int) else k
    theirs = nn.Conv2d(5, 4, (kh, kw), stride, padding=(kh // 2, kw // 2))
    with torch.no_grad():
        ours.weight.copy_(torch.randn(ours.weight.shape, generator=g))
        ours.bias.copy_(torch.randn(4, generator=g))
        theirs.weight.copy_(ours.weight)
        theirs.bias.copy_(ours.bias)
    x = torch.randn(2, 5, 16, 22, generator=g)
    got = ours(x, torch.float32)
    assert got.shape == theirs(x).shape
    assert torch.allclose(got, theirs(x), atol=1e-5, rtol=0)


@pytest.mark.parametrize("enc, kind", [("fnet", "instance"), ("cnet", "batch")])
def test_encoder_matches_the_reference(model, weights, enc, kind):
    """(a) ``BasicEncoder`` (stride-2 padding, instance norm in fnet, batch
    norm in eval mode in cnet) against the reference's, fp32, with running
    statistics away from 0 and 1 so that eval mode shows."""
    g = torch.Generator().manual_seed(2)
    x = torch.rand(B, 3, H, W, generator=g) * 2 - 1
    w = dict(weights)
    m = getattr(model, enc)
    if kind == "batch":
        m = R.BasicEncoder(256, "batch")
        m.load_state_dict({k[5:]: v for k, v in weights.items() if k.startswith("cnet.")})
        for bn in m.modules():
            if isinstance(bn, BatchNorm):
                bn.running_mean.uniform_(-0.5, 0.5, generator=g)
                bn.running_var.uniform_(0.5, 1.5, generator=g)
        w.update({f"cnet.{k}": v for k, v in m.state_dict().items()})
    got = m(x, torch.float32)
    want = ref._encoder(x, w, enc, kind, torch.float32)
    assert got.shape == want.shape == (B, 256, H // 8, W // 8)
    assert torch.allclose(got, want, atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_lookup_zero_taps_and_x_slowest_order():
    """(a) On a hand-made volume whose entry at (ty, tx) is 1 + tx + 100 ty:
    tap i * 9 + j samples x + d_i, y + d_j (the x offset varies slowest),
    taps outside the map read 0, and a half-pixel x is the mean of two
    columns."""
    th, tw = 6, 7
    ty, tx = torch.meshgrid(torch.arange(th), torch.arange(tw), indexing="ij")
    vol = (1 + tx + 100 * ty).to(torch.float32).view(1, 1, 1, th, tw)
    d = range(-4, 5)
    for x, y in ((0.0, 0.0), (3.0, 2.0), (1.5, 4.0)):
        coords = torch.tensor([x, y]).view(1, 2, 1, 1)
        got = R.lookup_corr_all_pairs([vol], coords, 4).view(81)
        for i, dx in enumerate(d):
            for j, dy in enumerate(d):
                cx, cy = x + dx, y + dy
                cols = [c for c in (int(np.floor(cx)), int(np.ceil(cx)))]
                inside = [c for c in dict.fromkeys(cols) if 0 <= c < tw]
                if not 0 <= cy < th:
                    want = 0.0
                else:
                    want = sum(1 + c + 100 * cy for c in inside) / len(dict.fromkeys(cols))
                assert float(got[i * 9 + j]) == pytest.approx(want, abs=1e-4), (x, y, dx, dy)


def test_lookup_matches_the_reference():
    """(a) Random 4-level pyramid (down to 1x1) and random coordinates,
    some far outside the map."""
    g = torch.Generator().manual_seed(3)
    corr = torch.randn(B, 8, 12, 8, 12, generator=g)
    pyr = R.build_corr_pyramid(corr, 4)
    assert pyr[-1].shape[-2:] == (1, 1)
    coords = R.coords_grid(B, 8, 12, "cpu") + torch.randn(B, 2, 8, 12, generator=g) * 6
    got = R.lookup_corr_all_pairs(pyr, coords, 4)
    want = ref._lookup([p.reshape(-1, 1, *p.shape[-2:]) for p in pyr], coords, 4,
                       torch.float32)
    assert got.shape == (B, 324, 8, 12)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_sep_conv_gru_matches_the_reference(model, weights):
    g = torch.Generator().manual_seed(4)
    h = torch.tanh(torch.randn(B, 128, 8, 12, generator=g))
    x = torch.randn(B, 256, 8, 12, generator=g)
    got = model.update_block.gru(h, x, torch.float32)
    assert torch.allclose(got, ref._gru(h, x, weights, torch.float32), atol=BLOCK_TOL, rtol=0)


def test_convex_upsample_zero_border_and_quarter_mask(model, weights):
    """(a) A flow of 1 px under uniform masks is 8 px inside and 8 x (the
    share of the 3x3 neighbours inside the map) at the border (zeros
    beyond it, not the edge repeated); the mask head is the published
    ``0.25 * mask(net)``; random inputs match the reference."""
    flow = torch.ones(1, 2, 4, 5)
    up = R.convex_upsample_zeros(flow, torch.zeros(1, 576, 4, 5))
    assert up.shape == (1, 2, 32, 40)
    assert torch.allclose(up[0, :, 8:24, 8:32], torch.full((2, 16, 24), 8.0))
    assert torch.allclose(up[0, :, 0, 0], torch.full((2,), 8.0 * 4 / 9))
    assert torch.allclose(up[0, :, 0, 12], torch.full((2,), 8.0 * 6 / 9))
    g = torch.Generator().manual_seed(5)
    net = torch.tanh(torch.randn(B, 128, 8, 12, generator=g))
    ub = model.update_block
    plain = ub.mask[2](F.relu(ub.mask[0](net, torch.float32)), torch.float32)
    assert torch.allclose(ub.up_mask(net, torch.float32), 0.25 * plain)
    # the head runs in the call's dtype, as under the published autocast
    half = ub.mask[2](F.relu(ub.mask[0](net, torch.bfloat16)), torch.bfloat16)
    assert torch.equal(ub.up_mask(net, torch.bfloat16), 0.25 * half.float())
    flow = torch.randn(B, 2, 8, 12, generator=g)
    mask = torch.randn(B, 576, 8, 12, generator=g)
    assert torch.allclose(R.convex_upsample_zeros(flow, mask), ref._upsample(flow, mask),
                          atol=1e-5, rtol=0)


def test_fp32_flow_matches_the_reference(model, frames, ref_flow):
    """(b) The whole ``raft_flow`` at 12 iterations in fp32."""
    got = R.raft_flow(model, *frames, 12, FP32)
    assert got.shape == ref_flow.shape == (B, H, W, 2)
    assert float(torch.linalg.vector_norm(ref_flow, dim=-1).mean()) > 1.0   # it moves
    assert float(_epe(got, ref_flow).max()) < FP32_EPE_PX


def test_bf16_flow_within_tolerance_and_bf16_coordinates_fail_it(model, frames, ref_flow,
                                                                 monkeypatch):
    """(c) The product precision (bf16 convolutions, the rest fp32) is
    within the bf16 tolerance; the same run with the coordinates carried in
    bf16 (``coords0``, each update's delta, so ``coords1``, the lookup's
    centres and the flow) is not, nor is the reference's all-bf16 control
    (0.21-0.24 px measured, at ~2 px of flow)."""
    got = R.raft_flow(model, *frames, 12, R.RAFT_BASIC)
    assert float(_epe(got, ref_flow).max()) < BF16_EPE_PX
    grid, update = R.coords_grid, model.update_block.forward

    def bf16_delta(*args):
        net, delta = update(*args)
        return net, delta.to(torch.bfloat16)

    monkeypatch.setattr(R, "coords_grid", lambda *a: grid(*a).to(torch.bfloat16))
    monkeypatch.setattr(model.update_block, "forward", bf16_delta)
    rounded = R.raft_flow(model, *frames, 12, R.RAFT_BASIC)
    monkeypatch.undo()
    assert float(_epe(rounded, ref_flow).max()) > BF16_EPE_PX
    control = ref.flow(*frames, CONFIG, ref.weights(CONFIG, SEED, "cpu"), ref.CONTROL_PRECISION)
    assert float(_epe(control, ref_flow).max()) > BF16_EPE_PX


def test_basic_raft_takes_its_own_architecture_on_the_all_pairs_volume(model, frames):
    """A call may change the dtype or the iterations, not a width, and not
    the correlation form: the published net has only the all-pairs volume
    (the escalation ladder reads ``materialize_corr``)."""
    with pytest.raises(ValueError, match="feature_dim"):
        R.raft_flow(model, *frames, 2, R.INFERENCE_CONFIG)
    with pytest.raises(ValueError, match="all-pairs"):
        R.raft_flow(model, *frames, 2, replace(FP32, materialize_corr=False))
    assert R.raft_flow(model, *frames, 2, replace(FP32, iters=5)).shape == (B, H, W, 2)
    assert not hasattr(model, "update") and not hasattr(R.RAFTConfig(), "architecture")


def _processor(model, tuned):
    seq = dict(height=H, width=W, n_frames=3, expansion=0.08, foe=(40.0, 30.0),
               drone_radius=5, drone_start=(20.0, 44.0), drone_velocity=(2.0, 1.0))
    cfg = RunConfig(dataset="synthetic", flow_source="RAFT", batch_size=B)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(**seq))
    return Processor(cfg, device="cpu", raft=R.RAFTRoute(model, tuned))


def test_processor_route_runs_the_basic_model(model):
    """(e) The Processor's RAFT route, pairs and chains, gives
    ``raft_flow_batch_tuned``'s flow of the given model and operating point
    (3 iterations)."""
    tuned = R.TunedRAFT(iters=3, config=R.RAFT_BASIC)
    proc = _processor(model, tuned)
    frames = torch.as_tensor(np.stack([proc.dataset.get_frame(i) for i in range(3)]))
    want = R.raft_flow_batch_tuned(frames[:-1], frames[1:], model, tuned, "cpu")
    pairs = proc._flow_pairs(frames[:-1], frames[1:], FlowSource.RAFT)
    chain = proc._flow_from_staged(proc._stage_batch([0, 1], FlowSource.RAFT),
                                   FlowSource.RAFT)
    assert torch.equal(pairs, want)
    # the chain encodes each frame once: the same convolutions, another batch
    assert torch.allclose(chain, want, atol=1e-2, rtol=0)
    fewer = R.raft_flow_batch_tuned(frames[:-1], frames[1:], model,
                                    R.TunedRAFT(iters=2, config=R.RAFT_BASIC), "cpu")
    assert not torch.allclose(fewer, want, atol=1e-2, rtol=0)


def test_cli_raft_arch_basic_hands_the_seeded_model_to_execute(monkeypatch, caplog):
    """(e) ``--raft-arch basic --raft-seed 11`` hands ``execute`` the published
    model drawn from seed 11 at RAFT_BASIC and 12 iterations, with a
    warning; the default hands nothing."""
    from mav_detection_tpu_torch.cli import main as cli

    seen = []
    monkeypatch.setattr(cli, "execute", lambda config, device, **kw: seen.append(kw))
    base = ["--dataset", "synthetic", "--device", "cpu", "--flow-source", "RAFT", "--headless"]
    with caplog.at_level(logging.WARNING):
        cli.main(base + ["--raft-arch", "basic", "--raft-seed", "11"])
    cli.main(base)
    route = seen[0]["raft"]
    assert seen[1] == {}
    assert route.tuned == R.TunedRAFT(iters=12, config=R.RAFT_BASIC)
    assert route.model.config is R.RAFT_BASIC
    assert isinstance(route.model, R.BasicRAFT)
    drawn = R.create_basic_raft(torch.Generator().manual_seed(11)).state_dict()
    assert all(torch.equal(v, drawn[k]) for k, v in route.model.state_dict().items())
    assert "random weights" in caplog.text
    with pytest.raises(SystemExit):
        cli.main(base + ["--raft-arch", "small"])


def test_spans_six_with_lookup_and_update_per_iteration(model, frames):
    """(f) A recording tracer gets ``raft`` and its five stages, the lookup
    and the update once per iteration, each inside ``raft``."""
    tracer = Tracer()
    with recording(tracer):
        R.raft_flow(model, *frames, 3, R.RAFT_BASIC)
    counts = {}
    for s in tracer.spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts == {"raft": 1, "raft.encode": 1, "raft.corr": 1, "raft.lookup": 3,
                      "raft.update": 3, "raft.upsample": 1}
    top = [i for i, s in enumerate(tracer.spans) if s.name == "raft"]
    assert [s.parent for s in tracer.spans if s.name != "raft"] == top * 9


def test_roofline_counts_the_model_convolutions_and_the_matmul(model, frames):
    """(g) ``raft_roofline.pair_flops`` equals the operations that
    ``layers.conv_flops``'s hooks count on the port's model (the mask head
    once), plus the correlation matmul, at 3 iterations and one pair."""
    cfg = dict(CONFIG, height=H, width=W, raft=dict(CONFIG["raft"], iters=3))
    fl = conv_flops(model, lambda: R.raft_flow(model, frames[0][:1], frames[1][:1], 3,
                                               R.RAFT_BASIC))
    # every convolution in bf16, the heads too, as under the published autocast
    assert fl["bf16"] > 0 and fl["fp32"] == 0
    corr = 2.0 * ((H // 8) * (W // 8)) ** 2 * 256
    assert raft_roofline.pair_flops(cfg) == fl["bf16"] + fl["fp32"] + corr

"""The CUDA kernel against its plain PyTorch version, on the card.

These need an NVIDIA card with nvcc (they build csrc/ at first use) and skip
elsewhere. On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.flow import farneback_iter as ti

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from mav_detection_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _inputs(dev, b, h, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    R0 = torch.randn(b, 5, h, w, device=dev, generator=g) * 10
    R1 = R0 + torch.randn(b, 5, h, w, device=dev, generator=g)
    flow = torch.randn(b, 2, h, w, device=dev, generator=g) * 6
    return R0, R1, flow, tf.border_scale_map(h, w, dev)


@pytest.mark.parametrize("b,h,w,S,win", [
    (3, 45, 67, 8, 12), (1, 33, 257, 16, 12), (2, 17, 19, 4, 8), (1, 5, 40, 8, 16),
    (2, 70, 301, 8, 12),      # several tiles both ways, W not a multiple of 32
    (1, 50, 130, 32, 12)])    # S=32: a wider A window than the main path's
def test_kernels_bit_exact_with_plain_version(dev, b, h, w, S, win):
    R0, R1, flow, border = _inputs(dev, b, h, w)
    out = torch.empty_like(flow)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, win, S)
    torch.cuda.synchronize()
    ref = ti.box_solve_ref(ti.update_matrices_ref(R0, R1, flow, border, S), win)
    assert torch.equal(out, ref)
    a = ti.farneback_iterate(R0, R1, flow, border, 5, win, S)
    assert torch.equal(a, ti.farneback_iterate_ref(R0, R1, flow, border, 5, win, S))


@pytest.mark.parametrize("tile", sorted(ti.TILES))
def test_every_tile_bit_exact(dev, tile):
    R0, R1, flow, border = _inputs(dev, 2, 75, 150)
    out = torch.empty_like(flow)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 8, tile=tile)
    torch.cuda.synchronize()
    ref = ti.box_solve_ref(ti.update_matrices_ref(R0, R1, flow, border, 8), 12)
    assert torch.equal(out, ref)
    info = ti.fused_kernel_info(12, 8, tile)
    assert info["smem_bytes"] == ti.fused_smem_bytes(tile, 6, 8)
    assert info["blocks_per_sm"] >= 1 and info["registers"] > 0


def test_launch_counters_and_validation(dev):
    R0, R1, flow, border = _inputs(dev, 1, 24, 32)
    ti.reset_launch_counts()
    ti.farneback_iterate(R0, R1, flow, border, 3, 12, 8)
    assert ti.LAUNCHES == {"farneback_iterate_fused": 3}
    out = torch.empty_like(flow)
    with pytest.raises(ValueError, match="contiguous"):
        ti.iterate_fused_cuda(R0, R1, flow.transpose(2, 3), border, out, 12, 8)
    with pytest.raises(ValueError, match="float32"):
        ti.iterate_fused_cuda(R0.double(), R1, flow, border, out, 12, 8)
    with pytest.raises(ValueError, match="shared memory"):
        ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 300)
    with pytest.raises(ValueError, match="must not be flow"):
        ti.iterate_fused_cuda(R0, R1, flow, border, flow, 12, 8)
    assert ti.LAUNCHES["farneback_iterate_fused"] == 3


def test_flow_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    prev = (rng.random((2, 64, 96)) * 255).astype(np.uint8)
    curr = np.roll(prev, (1, 2), axis=(1, 2))
    card = tf.farneback_flow_batch(prev, curr, device=dev).cpu().numpy()
    cpu = tf.farneback_flow_batch(prev, curr, device="cpu").numpy()
    # same ops; only the matmuls' sum order differs between cuBLAS and CPU
    np.testing.assert_allclose(card, cpu, atol=1e-3)

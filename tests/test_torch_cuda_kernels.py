"""The CUDA kernels against their plain PyTorch versions, on the card.

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


@pytest.mark.parametrize("b,h,w,S,win", [(3, 45, 67, 8, 12), (1, 33, 257, 16, 12),
                                         (2, 17, 19, 4, 8), (1, 5, 40, 8, 16)])
def test_kernels_bit_exact_with_plain_version(dev, b, h, w, S, win):
    R0, R1, flow, border = _inputs(dev, b, h, w)
    M = torch.empty_like(R0)
    ti.update_matrices_cuda(R0, R1, flow, border, M, S)
    M_ref = ti.update_matrices_ref(R0, R1, flow, border, S)
    out = torch.empty_like(flow)
    ti.box_solve_cuda(M_ref, out, win)
    torch.cuda.synchronize()
    assert torch.equal(M, M_ref)
    assert torch.equal(out, ti.box_solve_ref(M_ref, win))
    a = ti.farneback_iterate(R0, R1, flow, border, 5, win, S)
    assert torch.equal(a, ti.farneback_iterate_ref(R0, R1, flow, border, 5, win, S))


def test_launch_counters_and_validation(dev):
    R0, R1, flow, border = _inputs(dev, 1, 24, 32)
    ti.reset_launch_counts()
    ti.farneback_iterate(R0, R1, flow, border, 3, 12, 8)
    assert ti.LAUNCHES == {"farneback_update_matrices": 3, "farneback_box_solve": 3}
    M = torch.empty_like(R0)
    with pytest.raises(ValueError, match="contiguous"):
        ti.update_matrices_cuda(R0, R1, flow.transpose(2, 3), border, M, 8)
    with pytest.raises(ValueError, match="float32"):
        ti.box_solve_cuda(M.double(), torch.empty_like(flow), 12)
    with pytest.raises(ValueError, match="m <= 8"):
        ti.box_solve_cuda(M, torch.empty_like(flow), 18)
    assert ti.LAUNCHES["farneback_update_matrices"] == 3


def test_flow_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    prev = (rng.random((2, 64, 96)) * 255).astype(np.uint8)
    curr = np.roll(prev, (1, 2), axis=(1, 2))
    card = tf.farneback_flow_batch(prev, curr, device=dev).cpu().numpy()
    cpu = tf.farneback_flow_batch(prev, curr, device="cpu").numpy()
    # same ops; only the matmuls' sum order differs between cuBLAS and CPU
    np.testing.assert_allclose(card, cpu, atol=1e-3)

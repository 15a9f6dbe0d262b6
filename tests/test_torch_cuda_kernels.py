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


@pytest.mark.parametrize("h,w,S", [(480, 752, 8), (240, 376, 8), (120, 188, 8),
                                   (240, 320, 8), (1024, 1920, 16)])
def test_one_frame_pair_per_launch_bit_exact(dev, h, w, S):
    """b = 1, the scan engine's and entry()'s shape, at every layer of the
    752x480 pyramid, at 240x320 and at 1920x1024."""
    R0, R1, flow, border = _inputs(dev, 1, h, w)
    out = torch.empty_like(flow)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, S)
    torch.cuda.synchronize()
    assert torch.equal(out, ti.box_solve_ref(
        ti.update_matrices_ref(R0, R1, flow, border, S), 12))


def test_dense_scan_never_synchronises(dev):
    """The dense scan loop with every synchronisation an error: 13 launches
    per transition, results equal to the CPU's within the flow's 1e-3 px."""
    from mav_detection_tpu_torch.pipeline.detector import DetectionStep
    from mav_detection_tpu_torch.pipeline.temporal import detect_sequence_scan

    rng = np.random.default_rng(0)
    T, h, w, n = 4, 96, 128, 64
    frames = (rng.random((T, h, w)) * 255).astype(np.uint8)
    host = (frames, np.zeros((T, 3), np.float32), np.ones(T, np.float32),
            np.zeros((T, h, w), np.uint8), np.zeros((T, h, w), bool),
            np.ones((T, h, w), np.float32), np.full((T, 2), 50.0, np.float32))
    syx = np.stack([rng.integers(0, h, (T - 1, 2 * n)),
                    rng.integers(0, w, (T - 1, 2 * n))], -1)
    kw = dict(params=tf.tuned_flow_params(h, w), config=DetectionStep(foe_samples=n))
    args = [torch.as_tensor(a).to(dev) for a in host]
    syx_d = torch.as_tensor(syx).to(dev)
    detect_sequence_scan(*args, sample_yx=syx_d, **kw)      # fills the caches
    torch.cuda.synchronize()
    ti.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, hist = detect_sequence_scan(*args, sample_yx=syx_d, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ti.LAUNCHES["farneback_iterate_fused"] == 13 * (T - 1)
    cpu, cpu_hist = detect_sequence_scan(*(torch.as_tensor(a) for a in host),
                                         sample_yx=torch.as_tensor(syx), **kw)
    np.testing.assert_allclose(hist.buffer.cpu().numpy(), cpu_hist.buffer.numpy(),
                               atol=1e-3)
    assert out.foe.shape == (T - 1, 2) and bool(torch.isfinite(out.foe).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 0.02), (torch.bfloat16, 0.5)])
def test_raft_on_card_matches_cpu(dev, dtype, tol):
    """RAFT (no hand kernel: cuDNN convolutions, cuBLAS matmuls, gathers)
    with the shipped weights, card against CPU at 64x96."""
    from mav_detection_tpu_torch.data.scene import make_scene
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.models import raft as tr

    prev, curr, _ = make_scene(0, h=64, w=96, drone_pos=(40.0, 30.0), drone_radius=6)
    cfg = tr.RAFTConfig(materialize_corr=False, dtype=dtype)
    card, cpu = (tr.raft_flow(pretrained.load_raft(d), torch.from_numpy(prev)[None].to(d),
                              torch.from_numpy(curr)[None].to(d), 6, cfg)[0].cpu().numpy()
                 for d in (dev, "cpu"))
    np.testing.assert_allclose(card, cpu, atol=tol)


def test_sky_mask_on_card_matches_cpu(dev):
    from mav_detection_tpu_torch.data.scene import make_scene
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.models import sky_segmentation as ts

    frame = np.repeat(make_scene(0, h=64, w=96)[0][..., None], 3, -1)
    card = ts.sky_mask(pretrained.load_sky(dev), frame, dev).cpu().numpy()
    cpu = ts.sky_mask(pretrained.load_sky("cpu"), frame, "cpu").numpy()
    assert (card == cpu).mean() >= 0.995

"""The CUDA kernels against their plain PyTorch version, on the card:
``farneback_iterate_fused`` as scheduled, on its row-streaming strips and on
the tile design's blocks; the polynomial expansion's band kernel
(``farneback_expand``) on its fused and two-pass routes.

These need an NVIDIA card with nvcc (they build csrc/ at first use) and skip
elsewhere. On a machine with one (``--noconftest`` where jax is not
installed: tests/conftest.py imports it, these tests need none of it):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.flow import farneback_expand as fe
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
    """The tile design's blocks on each of their tiles."""
    R0, R1, flow, border = _inputs(dev, 2, 75, 150)
    out = torch.empty_like(flow)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 8, geometry=tile)
    torch.cuda.synchronize()
    ref = ti.box_solve_ref(ti.update_matrices_ref(R0, R1, flow, border, 8), 12)
    assert torch.equal(out, ref)
    info = ti.fused_kernel_info(12, 8, tile)
    assert info["smem_bytes"] == ti.tiled_smem_bytes(tile, 6, 8)
    assert info["blocks_per_sm"] >= 1 and info["registers"] > 0


@pytest.mark.parametrize("design", ["fused", "strips", "tiled"])
@pytest.mark.parametrize("b,h,w,S,win", [
    (2, 75, 150, 8, 12), (1, 24, 32, 8, 12), (8, 120, 188, 8, 12), (8, 480, 752, 8, 12),
    (2, 75, 150, 16, 12), (1, 120, 188, 16, 12), (2, 75, 150, 8, 9), (2, 75, 150, 8, 15),
    (1, 24, 32, 16, 15)])
def test_both_designs_bit_exact(dev, design, b, h, w, S, win):
    """farneback_iterate_fused as scheduled, its row-streaming strips on
    every shape, and the tile design, each against the plain version: a row
    pitch that is no multiple of 16 B (75x150), an image shorter than 2S + 2
    rows (24x32), the coarsest layer at b=8, the finest, S=16 and the
    run-time-m kernel (winsize 9 and 15)."""
    R0, R1, flow, border = _inputs(dev, b, h, w)
    out = torch.empty_like(flow)
    sms = ti._sm_count(dev.index)
    geo = {"fused": None, "strips": ti.strip_geometry(b, h, w, win, S, sms),
           "tiled": ti.tile_for(b, h, w, sms)}[design]
    ti.iterate_fused_cuda(R0, R1, flow, border, out, win, S, geometry=geo)
    torch.cuda.synchronize()
    assert torch.equal(out, ti.box_solve_ref(
        ti.update_matrices_ref(R0, R1, flow, border, S), win))


@pytest.mark.parametrize("strip,rows", [(1, 3), (16, 1), (37, 5), (75, 40), (116, 7),
                                        (150 // 2, 150), (108, 120)])
def test_fused_geometries_bit_exact(dev, strip, rows):
    """Strips of one column up to the widest, odd and even, runs of one row
    up to runs that cross from one strip column into the next: the same
    result."""
    R0, R1, flow, border = _inputs(dev, 2, 75, 150)
    geo = ti.strip_geometry(2, 75, 150, 12, 8, 132, strip=strip, rows=rows)
    out = torch.empty_like(flow)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 8, geometry=geo)
    torch.cuda.synchronize()
    assert torch.equal(out, ti.box_solve_ref(
        ti.update_matrices_ref(R0, R1, flow, border, 8), 12))


@pytest.mark.parametrize("h,w,win,S", [(480, 752, 12, 8), (1024, 1920, 12, 16),
                                       (120, 188, 9, 8), (75, 150, 15, 16)])
def test_fused_kernel_info(dev, h, w, win, S):
    """The card's resources agree with the Python reckoning the geometry is
    chosen from: shared memory, and one block an SM."""
    sms = ti._sm_count(dev.index)
    geo = ti.strip_geometry(8, h, w, win, S, sms)
    info = ti.fused_kernel_info(win, S, geo)
    assert info["smem_bytes"] == geo.smem_bytes == ti.strip_smem_bytes(
        geo.strip, win // 2, S)
    assert info["blocks_per_sm"] == 1
    tile = ti.fused_kernel_info(win, S, (32, 32))
    assert tile["smem_bytes"] == ti.tiled_smem_bytes((32, 32), win // 2, S)
    assert tile["blocks_per_sm"] >= 1
    # the kernels' __launch_bounds__: 65536 registers over 512 threads
    assert 0 < info["registers"] <= 128


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
    strips = ti.strip_geometry(1, 24, 32, 12, 8, 132)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 8, geometry=strips)
    ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 8, geometry=(32, 64))
    with pytest.raises(ValueError, match="shared memory"):
        ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 300, geometry=(32, 64))
    with pytest.raises(ValueError, match="tiles"):
        ti.iterate_fused_cuda(R0, R1, flow, border, out, 12, 8, geometry=(8, 8))
    assert ti.LAUNCHES == {"farneback_iterate_fused": 5}


def test_flow_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    prev = (rng.random((2, 64, 96)) * 255).astype(np.uint8)
    curr = np.roll(prev, (1, 2), axis=(1, 2))
    card = tf.farneback_flow_batch(prev, curr, device=dev).cpu().numpy()
    cpu = tf.farneback_flow_batch(prev, curr, device="cpu").numpy()
    # same weights and iteration; only the expansion's sum order differs: the
    # band kernel's taps in order on the card, the CPU's matmuls (and the
    # flow resize's matmuls, cuBLAS against the CPU's)
    np.testing.assert_allclose(card, cpu, atol=1e-3)


def _expand_layers(h, w):
    """``_poly_pyr_mats_np``'s arguments for every layer of the product's
    pyramid at (h, w), with ``_farneback_cf``'s smoothing."""
    out = []
    for scale in tf._pyramid_scales(h, w, tf.tuned_flow_params(h, w)):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth = tf._gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
        out.append((h, w, int(round(h * scale)), int(round(w * scale)), smooth, 8, 1.2))
    return out


@pytest.mark.parametrize("b,h,w", [(8, 480, 752), (8, 1024, 1920), (1, 480, 752),
                                   (1, 1024, 1920), (3, 37, 53)])
def test_expand_kernel_matches_plain_version(dev, b, h, w):
    """Both frames of each pair in one launch per layer (two on the
    two-pass layers), every layer of the product's pyramid, within 1e-5 of
    the coefficients' scale of the plain version (the matmuls, on the card:
    TF32 off), as the matmuls are held to XLA's on the CPU; a frame set
    alone (``poly_exp_pyr_cf``) gives the same coefficients bit for bit."""
    g = torch.Generator(device=dev).manual_seed(b * h)
    prev, curr = (torch.rand(b, h, w, device=dev, generator=g) * 255 for _ in range(2))
    routes = []
    for args in _expand_layers(h, w):
        _, _, lh, lw, smooth, n, sigma = args
        R0, R1 = tf.poly_exp_pyr_pair_cf(prev, curr, smooth, lh, lw, n, sigma)
        torch.cuda.synchronize()
        for got, frame in ((R0, prev), (R1, curr)):
            want = tf.poly_exp_pyr_ref(frame, smooth, lh, lw, n, sigma)
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert torch.equal(tf.poly_exp_pyr_cf(curr, smooth, lh, lw, n, sigma), R1)
        routes.append(len(tf._expand_plan(args, 2 * b)))
    if h >= 480:
        assert routes == [1, 1, 2]      # the coarsest layer in two passes


def test_expand_launch_counters_and_validation(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    prev, curr = (torch.rand(2, 480, 752, device=dev, generator=g) * 255 for _ in range(2))
    fe.reset_launch_counts()
    tf.farneback_flow_batch(prev, curr, device=dev)
    assert fe.LAUNCHES == {"farneback_expand_fused": 2, "farneback_expand_vertical": 1,
                           "farneback_expand_horizontal": 1}
    args = _expand_layers(480, 752)[0]
    _, _, lh, lw, smooth, n, sigma = args
    tf.poly_exp_pyr_cf(prev, smooth, lh, lw, n, sigma)
    assert fe.LAUNCHES["farneback_expand_fused"] == 3
    bands = tf._device_const("expand", args, dev)
    (k,) = tf._expand_plan(args, 4)
    ig = (1.0, 1.0, 1.0, 1.0)
    R0, R1 = (torch.empty(2, 5, lh, lw, device=dev) for _ in range(2))
    with pytest.raises(ValueError, match="contiguous"):
        fe.expand_cuda(prev.transpose(1, 2).contiguous().transpose(1, 2), curr, R0, R1,
                       bands, (k,), ig)
    with pytest.raises(ValueError, match="float32"):
        fe.expand_cuda(prev.double(), curr, R0, R1, bands, (k,), ig)
    with pytest.raises(ValueError, match="shape"):
        fe.expand_cuda(prev, curr[:1], R0, R1, bands, (k,), ig)
    with pytest.raises(RuntimeError, match="launch failed"):   # tw a multiple of 4
        fe.expand_cuda(prev, curr, R0, R1, bands, (k._replace(tw=30),), ig)
    with pytest.raises(RuntimeError, match="launch failed"):   # a window past the frame
        fe.expand_cuda(prev, curr, R0, R1, bands, (k._replace(wr=481),), ig)
    assert sum(fe.LAUNCHES.values()) == 5
    fe.expand_cuda(prev, curr, R0, R1, bands, (k,), ig)
    assert fe.LAUNCHES["farneback_expand_fused"] == 4


@pytest.mark.parametrize("h,w", [(480, 752), (1024, 1920)])
def test_expand_kernel_info(dev, h, w):
    """Every launch of the plan at b=8 runs two blocks an SM, as the plan
    counts on, with no local memory."""
    for args in _expand_layers(h, w):
        for k in tf._expand_plan(args, 16):
            info = fe.kernel_info(k)
            assert info["smem_bytes"] == k.smem <= fe.TWO_BLOCKS_SMEM
            assert 0 < info["registers"] <= 128 and info["local_bytes"] == 0
            assert info["blocks_per_sm"] >= 2


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


def test_generate_batch_on_card_matches_cpu(dev):
    """The scene generator (banded fp32 matmuls, gathers) on the same draws."""
    from mav_detection_tpu_torch.data import synthgen as sg

    draws = sg.draw_scenes(4, 96, 128, pan_max=6.0, generator=torch.Generator().manual_seed(0))
    card = sg.generate_batch(4, 96, 128, pan_max=6.0, draws=draws, device=dev)
    cpu = sg.generate_batch(4, 96, 128, pan_max=6.0, draws=draws, device="cpu")
    for f in sg.SynthScene._fields:
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        if b.dtype == torch.bool:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()), msg=f)


def _one_update(net, dev, dtype, draws, lr=1e-3):
    """One step of a trainer's loss and optimizer from the shipped weights
    at learning rate ``lr`` (the trainers' own first step runs at 0)."""
    from mav_detection_tpu_torch.cli import train as tt
    from mav_detection_tpu_torch.data.synthgen import generate_batch
    from mav_detection_tpu_torch.models import optim, pretrained
    from mav_detection_tpu_torch.models.raft import RAFT, RAFTConfig
    from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet
    from mav_detection_tpu_torch.models.yolo import TinyYOLO

    build, params = {"raft": (RAFT, pretrained.load_raft_params),
                     "sky": (SkyUNet, pretrained.load_sky_params),
                     "yolo": (TinyYOLO, pretrained.load_yolo_params)}[net]
    model = build()
    model.load_state_dict(params())
    model = model.to(dev)
    opt = optim.TrainOptimizer(model.parameters(), lambda c: lr,
                               weight_decay=1e-5 if net == "raft" else None)
    b, h, w = draws.ground_noise.shape
    sc = generate_batch(b, h, w, draws=draws, device=dev)
    opt.zero_grad()
    if net == "raft":
        loss = tt.raft_batch_loss(model, sc, 4, config=RAFTConfig(dtype=dtype))
    elif net == "sky":
        loss = tt.sky_batch_loss(model, sc, dtype)
    else:
        loss = tt.yolo_batch_loss(model, sc, "FLOW_UV", dtype)
    loss.backward()
    opt.step()
    return float(loss), {k: v.detach().cpu() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("net,dtype,loss_rtol,median_steps", [
    ("raft", torch.float32, 1e-4, 1e-3), ("raft", torch.bfloat16, 2e-2, 0.2),
    ("sky", torch.float32, 1e-4, 1e-3), ("sky", torch.bfloat16, 2e-2, 0.2),
    ("yolo", torch.float32, 1e-4, 1e-3), ("yolo", torch.bfloat16, 2e-2, 0.2)])
def test_train_step_on_card_matches_cpu(dev, net, dtype, loss_rtol, median_steps):
    """One update of each trainer card against CPU on the same draws: the
    loss within ``loss_rtol``; the parameters, in units of one step of the
    learning rate, with a median difference within ``median_steps`` (Adam
    normalises each gradient, so where one is rounding noise the update is
    too; bf16 rounds the activations to 8 bits)."""
    from mav_detection_tpu_torch.data.synthgen import draw_scenes

    draws = draw_scenes(2, 64, 96, generator=torch.Generator().manual_seed(3))
    lc, pc = _one_update(net, dev, dtype, draws)
    lh, ph = _one_update(net, "cpu", dtype, draws)
    assert lc == pytest.approx(lh, rel=loss_rtol)
    diff = torch.cat([(pc[k] - ph[k]).abs().flatten() for k in ph]) / 1e-3
    assert float(diff.median()) < median_steps


# ---------------------------------------------------------------- probe kernels
@pytest.mark.parametrize("S", [1, 8, 16])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rows,cols", [(37, 45), (13, 131), (64, 768), (3840, 752)])
def test_shift_probes_equal_their_plain_versions(dev, S, axis, rows, cols):
    """shift_chain and shift_gather (S = 8 compiled in, 1 and 16 through the
    run-time-S instance; 37x45 is off the blocks and tiles, 13x131 takes
    16-byte copies on axis 1 at S = 8 and 16; 64x768 the tools' default,
    3840x752 the fused kernel's finest layer at b=8) equal their plain
    versions and each other."""
    from mav_detection_tpu_torch.ops.flow import shift_probes as sp

    x, sy, fy = sp.shift_inputs(np.random.default_rng(S + axis), rows, cols, S, axis, dev)
    chain = sp.shift_chain(x, sy, fy, S, axis)
    gather = sp.shift_gather(x, sy, fy, S, axis)
    torch.cuda.synchronize()
    assert torch.equal(chain, sp.shift_chain_ref(x, sy, fy, S, axis))
    assert torch.equal(gather, sp.shift_gather_ref(x, sy, fy, S, axis))
    assert torch.equal(gather, chain)


@pytest.mark.parametrize("variant", ["A", "B", "C", "D", "T"])
@pytest.mark.parametrize("S,th,tw,m,bands", [(1, 5, 37, 3, 2), (8, 24, 752, 6, 2),
                                             (16, 7, 50, 6, 3), (8, 24, 752, 6, 20),
                                             (8, 24, 752, 6, 160), (8, 32, 64, 6, 1440),
                                             (1, 3, 8, 2, 2), (8, 24, 40, 5, 3),
                                             (2, 60, 20, 3, 2)])
def test_y_stage_equals_its_plain_version(dev, variant, S, th, tw, m, bands):
    """Off the tiles, the run-time-S instance (16-byte copies), the tool's
    default (20 bands), the fused kernel's finest layer at b=8 (160 bands)
    and its tile geometry (1440 tiles of 32x64); narrower than a tile,
    16-byte copies with S compiled in, bands taller than one block."""
    from mav_detection_tpu_torch.ops.flow import shift_probes as sp

    g = sp.YGeometry(S, th, tw, m)
    slab, sy, fy = sp.y_stage_inputs(np.random.default_rng(S), g, bands, dev)
    out = sp.y_stage(slab, sy, fy, S, m, variant)
    torch.cuda.synchronize()
    assert out.shape == (bands, 1, g.mrows, g.acols)
    assert torch.equal(out, sp.y_stage_ref(slab, sy, fy, S, m, variant))
    if variant in ("B", "T"):
        assert torch.equal(out, sp.y_stage(slab, sy, fy, S, m, "A"))


def test_probe_wrappers_count_and_refuse(dev):
    from mav_detection_tpu_torch.ops.flow import shift_probes as sp

    rng = np.random.default_rng(0)
    x, sy, fy = sp.shift_inputs(rng, 16, 40, 8, 0, dev)
    g = sp.YGeometry(8, 4, 16, 2)
    slab, ysy, yfy = sp.y_stage_inputs(rng, g, 2, dev)
    sp.reset_launch_counts()
    sp.shift_chain(x, sy, fy, 8, 0)
    sp.y_stage(slab, ysy, yfy, 8, 2, "T")
    assert sp.LAUNCHES["shift_chain"] == 1 and sp.LAUNCHES["y_stage_T"] == 1
    with pytest.raises(ValueError, match="float32"):
        sp.shift_gather(x.double(), sy, fy, 8, 0)
    with pytest.raises(ValueError, match="shape"):
        sp.shift_gather(x, sy[:-1], fy, 8, 0)
    with pytest.raises(ValueError, match="contiguous"):
        sp.shift_chain(x.t().contiguous().t(), sy, fy, 8, 0)
    with pytest.raises(ValueError, match="need"):
        sp.y_stage(slab, ysy[:, :-1], yfy, 8, 2, "A")
    with pytest.raises(ValueError, match="float32"):
        sp.y_stage(slab, ysy, yfy.half(), 8, 2, "C")
    assert sum(sp.LAUNCHES.values()) == 2
    info = sp.kernel_info("y_stage_A", 8, mrows=36)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    assert info["threads"] == 288 and info["dyn_smem_bytes"] == 4 * 5 * 53 * 36
    assert sp.kernel_info("shift_chain", 8)["dyn_smem_bytes"] == 4 * 81 * 32
    with pytest.raises(ValueError, match="mrows"):
        sp.kernel_info("y_stage_T", 8)

"""The port's row-sharded paths held to the JAX package and to the port's
unsharded functions: the row-halo exchange (``parallel/halo.py``) forward
and backward, spatial Farneback (``parallel/spatial.py``) and the spatial
engine, row-sharded RAFT inference (``raft_flow_spatial``), the RAFT train
step on a 2-D (data x rows) layout, and ``dryrun_multichip``.

Every sharded call spawns gloo ranks (3 where an inner band with two
neighbours matters) through ``parallel.mesh.launch``; the rank functions
are the port's own, so no rank imports JAX.

Tolerances: the reference's gate for spatial Farneback, 1e-3 px against
the unsharded separable solver (tests/test_parallel_pipeline.py); row-sharded
RAFT in fp32 against the unsharded net at 1e-4 px, well inside the port's
fp32 card-vs-CPU RAFT tolerance of 0.02 px (chip_smoke.RAFT_CARD_CPU_TOL_PX);
the 2-D train step at the reference's training gate (rtol 2e-2, atol 1e-3,
the JAX package's TestMultiDeviceTraining) with the loss at 1e-5.
"""
import copy
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mav_detection_tpu.ops.flow import farneback as jf
from mav_detection_tpu.parallel import farneback_flow_spatial as j_spatial
from mav_detection_tpu.parallel import make_mesh as j_make_mesh

from mav_detection_tpu_torch import entry
from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.models import raft as traft
from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.parallel import halo
from mav_detection_tpu_torch.parallel import mesh as pmesh
from mav_detection_tpu_torch.parallel import spatial as tsp
from mav_detection_tpu_torch.pipeline.processor import Processor

torch.set_num_threads(1)

TIMEOUT_S = 240.0
PARAMS = tf.FarnebackParams(warp="separable", levels=2, pyr_scale=0.5,
                            iterations=6, max_shift=8)
J_PARAMS = jf.FarnebackParams(warp="separable", levels=2, pyr_scale=0.5,
                              iterations=6, max_shift=8)
TINY_RAFT = dict(feature_dim=32, hidden_dim=32, context_dim=32, corr_levels=2,
                 corr_radius=2, iters=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def rng():
    """This file's own generator (not the repository-wide fixture)."""
    return np.random.default_rng(77)


def launch(fn, n, *args, **kw):
    return pmesh.launch(fn, n, "cpu", *args, timeout_s=TIMEOUT_S, **kw)


def scene(h, w):
    """A textured frame and its smooth non-uniform warp (tests/
    test_parallel_pipeline.py's family): trackable motion of ~3 px."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def tex(x, y):
        return (120 + 55 * np.sin(0.11 * x + 0.07 * y) + 30 * np.sin(0.31 * x - 0.17 * y)
                + 18 * np.sin(0.53 * x + 0.41 * y)).astype(np.float32)

    dx = 3.0 + 1.5 * np.sin(2 * np.pi * ys / h)
    dy = -2.0 + 1.0 * np.cos(2 * np.pi * xs / w)
    return tex(xs, ys), tex(xs - dx, ys - dy)


def numpy_exchange(x, wts, size, above, below):
    """Each rank's slab and band gradient of ``check_exchange``, from the
    whole array in numpy."""
    per = x.shape[-2] // size
    slabs, grad = [], np.zeros_like(x)
    for r in range(size):
        lo = max(r * per - above, 0)
        hi = min((r + 1) * per + below, x.shape[-2])
        slabs.append(x[..., lo:hi, :])
        grad[..., lo:hi, :] += (r + 1) * wts[..., lo:hi, :]
    return slabs, [grad[..., r * per:(r + 1) * per, :] for r in range(size)]


# ------------------------------------------------------------------- halo
@pytest.mark.parametrize("above,below", [(3, 2), (0, 4)])
def test_exchange_rows_forward_and_backward(rng, above, below):
    """3 ranks, bands of 5 rows: the exchanged slab is the whole array's
    rows around the band (shorter at the global edges), and the backward
    returns each halo's gradient to the rank that owns the rows."""
    x = rng.normal(size=(2, 15, 4)).astype(np.float32)
    wts = rng.normal(size=x.shape).astype(np.float32)
    got = launch(halo.check_exchange, 3, torch.from_numpy(x), above, below,
                 torch.from_numpy(wts), all_ranks=True)
    slabs, grads = numpy_exchange(x, wts, 3, above, below)
    for r, (slab, grad) in enumerate(got):
        np.testing.assert_array_equal(slab.numpy(), slabs[r], err_msg=f"rank {r}")
        np.testing.assert_allclose(grad.numpy(), grads[r], rtol=1e-6, err_msg=f"rank {r}")
    ref_slabs, ref_grads = halo.exchange_reference(torch.from_numpy(x), torch.from_numpy(wts),
                                                   3, above, below)
    for r in range(3):
        np.testing.assert_array_equal(ref_slabs[r].numpy(), slabs[r])
        np.testing.assert_allclose(ref_grads[r].numpy(), grads[r], rtol=1e-6)


def test_band_needs_divisible_rows():
    mesh = pmesh.Mesh(rank=1, size=3, device=torch.device("cpu"), ranks=(0, 1, 2))
    assert halo.band(torch.arange(9)[:, None], mesh)[:, 0].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="10 rows do not divide by 3 ranks"):
        halo.band(torch.zeros(10, 2), mesh)


# ----------------------------------------------------------- spatial Farneback
def test_unfused_preprocessing_matches_jax(rng):
    """The spatial solver's slab stages against the reference's:
    ``gaussian_blur``, ``resize_linear`` and ``poly_exp``."""
    img = (rng.random((30, 44)) * 255).astype(np.float32)
    blur = tf.gaussian_blur(torch.from_numpy(img)[None], 5, 1.0)[0].numpy()
    np.testing.assert_allclose(blur, np.asarray(jf._gaussian_blur(
        jnp.asarray(img)[..., None], 5, 1.0))[..., 0], atol=1e-4)
    small = tf.resize_linear(torch.from_numpy(img)[None], (15, 22))[0].numpy()
    np.testing.assert_allclose(small, np.asarray(jf._resize_linear(
        jnp.asarray(img)[..., None], (15, 22)))[..., 0], atol=1e-3)
    R = tf.poly_exp(torch.from_numpy(img)[None], 8, 1.2)[0].numpy()
    ref = np.asarray(jf._poly_exp(jnp.asarray(img)[..., None], 8, 1.2))[:, :, 0]
    np.testing.assert_allclose(np.moveaxis(R, 0, -1), ref, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def spatial_pair():
    return scene(96, 80)


def test_spatial_matches_unsharded_and_jax(spatial_pair):
    """96x80 over 3 ranks (bands of 32 and 16 rows at the two finer levels:
    both sharded, the coarsest replicated): within 1e-3 px of the port's
    unsharded separable solver and of JAX's ``farneback_flow_spatial`` on a
    3-device mesh."""
    prev, curr = spatial_pair
    got = launch(tsp.flow_spatial_rank, 3, torch.from_numpy(prev),
                 torch.from_numpy(curr), PARAMS).numpy()
    ref = tf._farneback_cf(torch.from_numpy(prev)[None], torch.from_numpy(curr)[None],
                           PARAMS)[0].numpy()
    assert got.shape == (96, 80, 2)
    assert np.abs(got - ref).max() < 1e-3
    jref = np.asarray(j_spatial(jnp.asarray(prev), jnp.asarray(curr), J_PARAMS,
                                j_make_mesh(3)))
    assert np.abs(got - jref).max() < 1e-3
    # the motion is recovered (a sharding fault shows at the band edges)
    assert np.abs(got[8:-8, 8:-8].mean((0, 1)) - (3.0, -2.0)).max() < 0.5


def test_spatial_rejects_indivisible_height():
    """The reference's ValueError, before any collective."""
    mesh = pmesh.Mesh(rank=0, size=3, device=torch.device("cpu"), ranks=(0, 1, 2))
    img = torch.zeros((190, 64))
    with pytest.raises(ValueError, match="image height 190 must divide by the mesh "
                                         "axis size 3"):
        tsp.farneback_flow_spatial(img, img, mesh=mesh)


def _spatial_processor(devices, engine, h=96, w=80, n_frames=4, **kw):
    cfg = RunConfig(logger=logging.getLogger("test"), dataset="synthetic",
                    mode="FLOW_FOE_CLUSTERING", flow_source="FARNEBACK",
                    batch_size=3, devices=devices, engine=engine, headless=True)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(
        height=h, width=w, n_frames=n_frames, expansion=0.03, foe=(38.0, 45.0)))
    proc = Processor(cfg, device="cpu", **kw)
    proc.save_images = False
    return proc


def test_spatial_engine_matches_batch():
    """--engine spatial on 3 ranks against the one-device batch engine, one
    batch of 3 pairs on the same seeded draws (tests/test_parallel_pipeline.py's
    tolerances: the warps differ, separable against the fused kernel's plain
    version)."""
    res_b = _spatial_processor(0, "batch").run_detection_foe()
    res_s = _spatial_processor(3, "spatial").run_detection_foe()
    assert sorted(res_b) == sorted(res_s) == [0, 1, 2]
    for i in res_b:
        np.testing.assert_allclose(res_b[i].foe_dense, res_s[i].foe_dense, atol=2.0)
        np.testing.assert_allclose([res_b[i].tpr_fixed, res_b[i].fpr_fixed],
                                   [res_s[i].tpr_fixed, res_s[i].fpr_fixed], atol=0.05)


def test_indivisible_height_takes_the_batched_solver(caplog, rng):
    """A height the mesh does not divide: the reference's warning and the
    unsharded batched solver, on the same device (no collective runs)."""
    mesh = pmesh.Mesh(rank=0, size=3, device=torch.device("cpu"), ranks=(0, 1, 2))
    proc = _spatial_processor(3, "spatial", mesh=mesh)
    prevs = torch.from_numpy((rng.random((2, 190, 64)) * 255).astype(np.float32))
    currs = torch.from_numpy((rng.random((2, 190, 64)) * 255).astype(np.float32))
    with caplog.at_level(logging.WARNING, logger="test"):
        flow = proc._flow_spatial_pairs(prevs, currs)
    assert "frame height 190 does not divide by the 3-device mesh" in caplog.text
    np.testing.assert_array_equal(flow.numpy(),
                                  tf._farneback_cf(prevs, currs, proc._farneback).numpy())


# --------------------------------------------------------------------- RAFT
@pytest.mark.parametrize("materialize", [False, True])
def test_raft_flow_spatial_matches_unsharded(rng, materialize):
    """Row-sharded RAFT inference on 2 ranks (the convolutions' halos, the
    global row grid, the gathered targets, the upsample's neighbour rows)
    against the unsharded net, fp32, with both correlation forms."""
    cfg = traft.RAFTConfig(**TINY_RAFT, materialize_corr=materialize)
    model = traft.create_raft(torch.Generator().manual_seed(0), cfg)
    i1 = torch.from_numpy(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8))
    i2 = torch.from_numpy(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8))
    ref = traft.raft_flow(model, i1[None], i2[None], iters=2, config=cfg)[0]
    got = launch(tsp.raft_spatial_rank, 2, i1, i2, model, 2, cfg)
    assert got.shape == (64, 96, 2)
    assert (got - ref).abs().max() < 1e-4


def test_raft_flow_spatial_rejects_bad_heights():
    mesh = pmesh.Mesh(rank=0, size=2, device=torch.device("cpu"), ranks=(0, 1))
    model = traft.create_raft(None, traft.RAFTConfig(**TINY_RAFT))
    with pytest.raises(ValueError, match="must divide by the mesh axis size 2"):
        tsp.raft_flow_spatial(torch.zeros(63, 96, 3), torch.zeros(63, 96, 3), model, mesh)
    with pytest.raises(ValueError, match="multiple of 8 rows and at least 24"):
        tsp.raft_flow_spatial(torch.zeros(40, 96, 3), torch.zeros(40, 96, 3), model, mesh)


def test_raft_train_step_on_a_2d_layout(rng):
    """One RAFT training step with the batch over 2 data ranks and the rows
    over 2 row ranks (4 gloo ranks): the loss equals the unsharded step's,
    the all-reduced gradient (through the halos' backward) equals the
    unsharded gradient tensor by tensor, and the weights after Adam agree at
    the reference's training gate. A first Adam step moves each weight by
    about lr whatever its gradient, so the gradients are what is held: the
    whole gradient within 1e-3 of its norm, each tensor within 2e-2 of its
    own. Sound runs read 2e-7 and 2e-6 on most inputs; on some the loss has
    a kink near the point, where the unsharded gradient itself moves 4e-3
    when the images move 4e-7 of their range, and row sharding's float
    order reads 1.1e-4 and 3.1e-3. A halo backward that drops the halos'
    gradients reads 0.27 and 0.58, gradients left un-reduced over the rows
    0.39 and 1.0."""
    cfg = traft.RAFTConfig(**TINY_RAFT)
    model = traft.create_raft(torch.Generator().manual_seed(0), cfg)
    img1 = torch.from_numpy((rng.random((4, 64, 48, 3)) * 255).astype(np.float32))
    img2 = torch.from_numpy((rng.random((4, 64, 48, 3)) * 255).astype(np.float32))
    gt = torch.from_numpy(rng.normal(size=(4, 64, 48, 2)).astype(np.float32))
    ref = copy.deepcopy(model)
    opt = torch.optim.Adam(ref.parameters(), lr=1e-4, eps=1e-8)
    loss = traft.raft_loss(ref, img1, img2, gt, iters=2, config=cfg).mean()
    loss.backward()
    opt.step()
    got_loss, state, grads = launch(entry.raft_train_step_2d_rank, 4, 2, 2, model,
                                    img1, img2, gt, 2, cfg)
    assert got_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    sq_err = sq_norm = 0.0
    for k, p in ref.named_parameters():
        err, norm = float((grads[k] - p.grad).norm()), float(p.grad.norm())
        assert err < 2e-2 * norm, (k, err, norm)
        sq_err, sq_norm = sq_err + err ** 2, sq_norm + norm ** 2
    assert sq_err ** 0.5 < 1e-3 * sq_norm ** 0.5
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=2e-2, atol=1e-3,
                                   err_msg=k)
    moved = max(float((state[k] - model.state_dict()[k]).abs().max()) for k in state)
    assert moved > 5e-5        # the step did update the weights


def test_dryrun_multichip_prints_every_stage(capsys):
    lines = entry.dryrun_multichip(2, "cpu")
    out = capsys.readouterr().out
    stages = ("detect ok", "Processor sharded detection ok", "chunked-video scan ok",
              "spatial row-sharded Farneback ok", "row-halo exchange ok",
              "raft train step ok on 1x2 (data,rows) layout")
    assert len(lines) == len(stages)
    for line, stage in zip(lines, stages):
        assert line.startswith("dryrun_multichip(2): ") and stage in line
        assert line in out

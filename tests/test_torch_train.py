"""Training of the port (``mav_detection_tpu_torch.cli.train``, the losses,
``models/optim.py``, the msgpack writer) against the JAX package, on the CPU
at tiny sizes.

Every comparison starts the port's net from the JAX net's parameters
(``convert.*_state_dict_from_flax``) and maps the JAX gradient tree through
the same tables. Nets run in fp32 here (the trainers' product dtype is bf16).
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mav_detection_tpu.models import checkpoint as jck
from mav_detection_tpu.models import raft as jraft
from mav_detection_tpu.models import sky_segmentation as jsky
from mav_detection_tpu.models import yolo as jyolo
from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.cli import train as ttrain
from mav_detection_tpu_torch.models import checkpoint as tck
from mav_detection_tpu_torch.models import optim
from mav_detection_tpu_torch.models import pretrained as tpre
from mav_detection_tpu_torch.models import raft as traft
from mav_detection_tpu_torch.models import sky_segmentation as tsky
from mav_detection_tpu_torch.models import yolo as tyolo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the losses: 1e-5 relative; every gradient leaf: 1e-4 of its largest
# magnitude (fp32 on both sides, reductions summed in other orders)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# the tiny RAFT of tests/test_train_driver.py with a radius-1 lookup (the
# JAX side's compile time grows with the taps), in fp32
TINY = dict(feature_dim=32, hidden_dim=32, context_dim=32, corr_levels=2,
            corr_radius=1, iters=2)


@pytest.fixture
def rng():
    return np.random.default_rng(8)


def _assert_grads(model, jax_grads, to_state_dict, **kw):
    ref = to_state_dict(jax.device_get(jax_grads), **kw)
    got = dict(model.named_parameters())
    assert set(ref) == set(got)
    for k, g in ref.items():
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


# ------------------------------------------------------------ losses + grads
def test_raft_loss_and_grad_match_jax(rng):
    cfg = jraft.RAFTConfig(**TINY, dtype=jnp.float32)
    model, params = jraft.create_raft(jax.random.PRNGKey(3), cfg, image_hw=(32, 48))
    b = 2
    img1 = rng.uniform(0, 255, (b, 32, 48, 3)).astype(np.float32)
    img2 = rng.uniform(0, 255, (b, 32, 48, 3)).astype(np.float32)
    flow = rng.normal(0, 2, (b, 32, 48, 2)).astype(np.float32)
    pw = 1 + 40 * (rng.random((b, 32, 48)) > 0.9).astype(np.float32)

    def loss_fn(p):
        per = jax.vmap(lambda a, c, f, w: jraft.raft_loss(p, model, a, c, f, iters=3,
                                                          pixel_weight=w))
        return jnp.mean(per(img1, img2, flow, pw))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    tcfg = traft.RAFTConfig(**TINY, dtype=torch.float32)
    m = traft.RAFT(tcfg)
    m.load_state_dict(convert.raft_state_dict_from_flax(jax.device_get(params), tcfg))
    t = [torch.from_numpy(a) for a in (img1, img2, flow, pw)]
    loss = traft.raft_loss(m, *t[:3], iters=3, pixel_weight=t[3]).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _assert_grads(m, jg, convert.raft_state_dict_from_flax, config=tcfg)
    # the unweighted branch (the reference's plain mean) is unit weights
    with torch.no_grad():
        plain = traft.raft_loss(m, *t[:3], iters=3)
        ones = traft.raft_loss(m, *t[:3], iters=3, pixel_weight=torch.ones_like(t[3]))
    np.testing.assert_allclose(plain.numpy(), ones.numpy(), rtol=1e-6)


def test_sky_loss_and_grad_match_jax(rng):
    model = jsky.SkyUNet(dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((32, 48, 3)))
    imgs = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    mask = rng.random((2, 32, 48)) > 0.6
    mask[1] = False                       # no positives: the count floors at 1
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jax.vmap(
        lambda im, g: jsky.sky_loss(p, model, im, g))(imgs, mask))))(params)
    m = tsky.SkyUNet()
    m.load_state_dict(convert.sky_state_dict_from_flax(jax.device_get(params)))
    loss = tsky.sky_loss(m, torch.from_numpy(imgs), torch.from_numpy(mask),
                         torch.float32).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _assert_grads(m, jg, convert.sky_state_dict_from_flax)


def test_yolo_loss_and_grad_match_jax(rng):
    model = jyolo.TinyYOLO(dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((64, 96, 3)))
    imgs = rng.uniform(0, 255, (4, 64, 96, 3)).astype(np.float32)
    # centres inside, on the far edge (the clip) and at 0; areas between
    # anchors and beyond the largest
    boxes = np.array([[30., 20., 10., 12.], [95.99, 63.99, 40., 30.],
                      [0., 5., 20., 22.], [50., 40., 70., 64.]], np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jax.vmap(
        lambda im, bx: jyolo.yolo_loss(p, model, im, bx))(imgs, boxes))))(params)
    m = tyolo.TinyYOLO()
    m.load_state_dict(convert.yolo_state_dict_from_flax(jax.device_get(params)))
    loss = tyolo.yolo_loss(m, torch.from_numpy(imgs), torch.from_numpy(boxes),
                           dtype=torch.float32).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _assert_grads(m, jg, convert.yolo_state_dict_from_flax)


def test_drone_weight_map_is_the_reference_reduce_window(rng):
    seg = rng.random((2, 20, 30)) > 0.97
    ref = np.stack([np.asarray(1.0 + 40.0 * jax.lax.reduce_window(
        jnp.asarray(s, jnp.float32)[None, :, :, None], -jnp.inf, jax.lax.max,
        (1, 5, 5, 1), (1, 1, 1, 1), "SAME")[0, :, :, 0]) for s in seg])
    got = ttrain.drone_weight_map(torch.from_numpy(seg), 40.0).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("peak,steps,cap", [(2.5e-4, 4000, 200), (1e-3, 1500, 100),
                                            (1e-3, 2, 100), (5e-4, 37, 200)])
def test_schedule_matches_optax_at_every_step(peak, steps, cap):
    ref = optax.warmup_cosine_decay_schedule(
        0.0, peak, warmup_steps=min(cap, steps // 10 + 1), decay_steps=steps)
    sched = optim.train_schedule(peak, steps, cap)
    counts = np.arange(steps + 1)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts, jnp.int32)))
    got = np.array([sched(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)
    assert sched(0) == 0.0                       # the first update runs at lr 0


def test_schedule_refuses_a_run_without_decay_steps():
    with pytest.raises(ValueError, match="positive decay_steps"):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=1, decay_steps=1)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.train_schedule(1e-3, 1, 100)


@pytest.mark.parametrize("weight_decay", [None, 1e-5])
def test_five_updates_match_the_optax_chain(rng, weight_decay):
    """clip_by_global_norm(1.0) then adam / adamw on the same gradients:
    gradient norms above and below the clip, a zero leaf, lr from 0."""
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup_steps=2, decay_steps=6)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(sched) if weight_decay is None
                     else optax.adamw(sched, weight_decay=weight_decay))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optim.TrainOptimizer(list(tp.values()),
                               optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6),
                               weight_decay=weight_decay)
    for step, scale in enumerate((5.0, 0.1, 3.0, 0.5, 20.0)):
        grads = {k: (rng.normal(0, scale, s).astype(np.float32) if k != "b" or step != 2
                     else np.zeros(s, np.float32)) for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")


def test_clip_is_optax_not_clip_grad_norm():
    g = [torch.tensor([3.0, 4.0])]
    norm = optim.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    # t / norm * max_norm, with no 1e-6 added to the divisor
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / torch.tensor(5.0) * 1.0)
    g = [torch.tensor([0.3, 0.4])]
    optim.clip_by_global_norm_(g, 1.0)
    assert g[0].tolist() == pytest.approx([0.3, 0.4])


# --------------------------------------------------------- the chunk loop
def _fake_run_chunk(delta):
    def run_chunk(params, opt_state, key, nsteps):
        return params + delta * nsteps, opt_state, key, np.ones(nsteps, np.float32)
    return run_chunk


def test_resume_never_regresses_below_initial(tmp_path):
    ckpt = str(tmp_path / "best.msgpack")
    with open(ckpt, "wb") as f:
        f.write(b"sentinel")
    best, losses = ttrain._scan_chunks(
        _fake_run_chunk(1.0), 0.0, None, 0, steps=10, chunk=2, label="t",
        selector=lambda p: -abs(float(p)), select_every=1, save_best_to=ckpt)
    assert best == 0.0
    with open(ckpt, "rb") as f:
        assert f.read() == b"sentinel"
    assert losses.shape == (10,)


def test_improving_candidate_is_selected_and_saved(tmp_path):
    ckpt = str(tmp_path / "best.msgpack")
    best, _ = ttrain._scan_chunks(
        _fake_run_chunk(1.0), -10.0, None, 0, steps=14, chunk=2, label="t",
        selector=lambda p: -abs(float(p)), select_every=1, save_best_to=ckpt)
    assert best == pytest.approx(0.0)
    assert tck.load_msgpack(ckpt) == 0.0


def test_no_selector_returns_final_params():
    best, _ = ttrain._scan_chunks(_fake_run_chunk(1.0), 0.0, None, 0, steps=6,
                                  chunk=3, label="t")
    assert best == 6.0


def test_module_keeps_its_best_weights_and_pulls_once_per_chunk(tmp_path):
    """A module's best snapshot is loaded back into it and written through
    ``to_tree``; each chunk's losses come back as one tensor."""
    lin = torch.nn.Linear(2, 1, bias=False)
    torch.nn.init.constant_(lin.weight, -4.0)
    pulls = []

    def run_chunk(params, opt_state, key, n):
        with torch.no_grad():
            params.weight += 1.0 * n
        losses = torch.arange(n, dtype=torch.float32)
        pulls.append(losses)
        return params, opt_state, key + n, losses

    ckpt = str(tmp_path / "m.msgpack")
    out, losses = ttrain._scan_chunks(
        run_chunk, lin, None, 0, steps=12, chunk=2, label="m",
        selector=lambda m: -abs(float(m.weight[0, 0].detach())), save_best_to=ckpt,
        to_tree=lambda sd: {k: v.numpy() for k, v in sd.items()})
    assert out is lin and float(lin.weight[0, 0].detach()) == 0.0
    assert len(pulls) == 6 and losses.shape == (12,)
    np.testing.assert_array_equal(tck.load_msgpack(ckpt)["weight"], [[0.0, 0.0]])


# ---------------------------------------------------------------- --devices
def test_device_count_errors_come_first_in_the_reference_order(monkeypatch):
    """The reference's checks come before any model or device work; then a
    missing card raises (data parallel itself: tests/test_torch_parallel_train.py)."""
    with pytest.raises(ValueError, match="16 > 8 available devices"):
        ttrain.train_raft(steps=2, batch=8, devices=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="--batch 6 must divide by --devices 8"):
        ttrain.train_raft(steps=2, batch=6, devices=8, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        ttrain.train_raft(steps=2, batch=8, devices=2, device="cuda")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        ttrain.main(["--model", "raft", "--devices", "2", "--steps", "2"])


def test_trainers_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ttrain.train_raft, ttrain.train_sky, ttrain.train_yolo):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            fn(steps=2)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        ttrain.main(["--model", "sky", "--steps", "2"])


# --------------------------------------------------------------- the CLI
def test_main_trains_two_steps_and_writes_what_both_packages_read(tmp_path, monkeypatch,
                                                                  caplog):
    """``--model sky`` for 2 steps at 64x64 into MAV_CHECKPOINT_PATH: a Flax
    msgpack file that the port and the JAX package both read, the selection
    and the evals logged (the other nets' writers: the next test and
    tests/test_torch_train_steps.py)."""
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    tpre.clear_cache()
    caplog.set_level(logging.INFO, logger="mav_detection_tpu_torch.train")
    common = ["--steps", "2", "--chunk", "1", "--batch", "2", "--hw", "64x64",
              "--device", "cpu"]
    ttrain.main(["--model", "sky"] + common)
    assert os.listdir(tmp_path) == ["sky.msgpack"]
    for tag in ("[sky] initial holdout", "[sky] step 2/2", "[sky] net TPR"):
        assert tag in caplog.text, tag
    from mav_detection_tpu.models import pretrained as jpre

    jpre.clear_cache()
    try:
        assert jpre.load_sky_params() is not None
    finally:
        jpre.clear_cache()
    assert tpre.load_sky("cpu") is not None
    tpre.clear_cache()


def test_main_raft_branch_writes_the_post_hoist_tree(tmp_path, monkeypatch, caplog):
    """``--model raft --resume``: resumes from the shipped weights (read
    from checkpoints/ before the root moves), trains 2 steps, writes
    raft.msgpack; the evals are stubbed here (they run at 240x320)."""
    init = tpre.load_raft_params()
    monkeypatch.setattr(tpre, "load_raft_params", lambda: init)
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setattr(ttrain, "eval_raft", lambda m: (0.1, 0.2))
    monkeypatch.setattr(ttrain, "eval_raft_detection", lambda m: (1.0, 1.0))
    caplog.set_level(logging.INFO, logger="mav_detection_tpu_torch.train")
    ttrain.main(["--model", "raft", "--resume", "--steps", "2", "--chunk", "2",
                 "--batch", "1", "--hw", "64x64", "--device", "cpu"])
    assert os.listdir(tmp_path) == ["raft.msgpack"]
    tree = tck.load_msgpack(str(tmp_path / "raft.msgpack"))
    assert set(tree["params"]) == {"fnet", "cnet", "refine", "mask_hidden", "mask_head"}
    assert "[raft] step 2/2" in caplog.text and "initial holdout" in caplog.text
    # the same keys and leaf shapes as the shipped checkpoint (migrated),
    # which the JAX package's reader restores into its template
    shipped = tck.load_msgpack(os.path.join(REPO, "checkpoints", "raft.msgpack"),
                               migrate=tpre._migrate_raft_state)
    flat = jax.tree_util.tree_flatten_with_path
    assert [(p, np.shape(v)) for p, v in flat(tree)[0]] == \
        [(p, np.shape(v)) for p, v in flat(shipped)[0]]
    tpre.clear_cache()


def test_eval_only_reads_the_shipped_checkpoint_and_gives_the_jax_number(caplog):
    from train_reference_numbers import NUMBERS

    tpre.clear_cache()
    caplog.set_level(logging.INFO, logger="mav_detection_tpu_torch.train")
    ttrain.main(["--model", "yolo", "--eval-only", "--device", "cpu"])
    iou, rate = NUMBERS["eval_yolo"]["APPEARANCE_RGB"]
    assert f"held-out mean IoU {iou:.3f}, detection rate {rate:.2f}" in caplog.text
    got = ttrain.eval_yolo(tpre.load_yolo("FLOW_UV", "cpu"), mode="FLOW_UV")
    assert got[0] == pytest.approx(NUMBERS["eval_yolo"]["FLOW_UV"][0], abs=0.005)
    assert got[1] == NUMBERS["eval_yolo"]["FLOW_UV"][1]


# ------------------------------------------------------------ checkpoints
CKPTS = ["raft", "sky", "yolo", "yolo_flow_uv", "yolo_flow_radial", "yolo_flow_foe_yolo"]
_TO, _FROM = {"raft": convert.raft_state_dict_from_flax,
              "sky": convert.sky_state_dict_from_flax}, \
    {"raft": convert.flax_from_raft_state_dict, "sky": convert.flax_from_sky_state_dict}


@pytest.mark.parametrize("name", CKPTS)
def test_writer_is_flax_bytes_and_convert_round_trips(name):
    path = os.path.join(REPO, "checkpoints", f"{name}.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    raw = tck.msgpack_restore(data)
    assert tck.msgpack_serialize(raw) == serialization.msgpack_serialize(
        serialization.msgpack_restore(data)) == data
    state = tck.load_msgpack(path, migrate=tpre._migrate_raft_state
                             if name == "raft" else None)
    kind = name if name in _TO else "yolo"
    fwd = _TO.get(kind, convert.yolo_state_dict_from_flax)
    inv = _FROM.get(kind, convert.flax_from_yolo_state_dict)
    back = inv(fwd(state))
    assert tck.msgpack_serialize(back) == tck.msgpack_serialize(state)


def test_writer_matches_flax_on_every_encoding(rng):
    tree = {"z": {"big": rng.normal(size=(70, 40)).astype(np.float32),
                  "i8": np.arange(-3, 300, dtype=np.int16), "s": np.float32(2.5)},
            "a": [1, -5, 127, 200, 70000, -200, -40000, 2 ** 40, 1.5, None, True,
                  "x" * 40, "y" * 300, b"b" * 70000],
            "k" * 20: {str(i): np.zeros((i,), np.uint8) for i in range(18)}}
    assert tck.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    assert tck.msgpack_serialize(torch.ones(2, 3)) == serialization.msgpack_serialize(
        np.ones((2, 3), np.float32))


def test_jax_package_reads_a_port_written_net(tmp_path, rng):
    """A port SkyUNet and TinyYOLO (random init) written by the port; the
    JAX package loads them into its templates, and its fp32 nets give the
    port's outputs."""
    m = tsky.create_sky_model(torch.Generator().manual_seed(4))
    path = str(tmp_path / "sky.msgpack")
    tck.save_msgpack(path, convert.flax_from_sky_state_dict(m.state_dict()))
    net = jsky.SkyUNet(dtype=jnp.float32)
    like = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((32, 48, 3)))
    params = jck.load_msgpack(path, like)
    img = rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(net.apply)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = m(torch.from_numpy(img).permute(2, 0, 1)[None], torch.float32)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # and a port TinyYOLO
    y = tyolo.create_yolo(torch.Generator().manual_seed(5))
    tck.save_msgpack(str(tmp_path / "yolo.msgpack"),
                     convert.flax_from_yolo_state_dict(y.state_dict()))
    ynet = jyolo.TinyYOLO(dtype=jnp.float32)
    like = jax.eval_shape(ynet.init, jax.random.PRNGKey(0), jnp.zeros((32, 48, 3)))
    yparams = jck.load_msgpack(str(tmp_path / "yolo.msgpack"), like)
    img = rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(ynet.apply)(yparams, jnp.asarray(img)))
    with torch.no_grad():
        got = y(torch.from_numpy(img)[None], torch.float32)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_save_load_and_load_if_exists(tmp_path):
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    path = str(tmp_path / "ckpt")
    tck.save(path, tree)
    back = tck.load(path, like=tree)
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"])
    with pytest.raises(FileExistsError):
        tck.save(path, tree, force=False)
    with pytest.raises(ValueError, match="shape"):
        tck.load(path, like={"params": {"w": np.zeros(3)}})
    assert tck.load_if_exists(str(tmp_path / "nope")) is None


# ----------------------------------------------------------- the blur
def test_shift_ladder_blur_is_cv2_gaussian_blur(rng):
    import cv2

    img = rng.random((96, 130)).astype(np.float32)
    ref = cv2.GaussianBlur(img, (0, 0), 1.5)
    np.testing.assert_allclose(ttrain.gaussian_blur_cv(img, 1.5), ref, rtol=0, atol=2e-6)

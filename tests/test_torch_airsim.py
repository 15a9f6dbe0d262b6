"""The port's AirSim side held to the JAX package's: ``data/airsim_flow.py``
(GT flow from camera matrices, in torch), the mock simulator and collector
(``sim/``, numpy copies), ``data/sim_data.py::SimDataset`` and the collect ->
SimDataset -> Processor slice, at 96x128 on the CPU.

Tolerances, with their reasons:
* ``calculate_flow`` against the JAX one on the same inputs: 2e-3 px. Both
  invert the view-projection matrix in fp32 (UE4 centimetres, entries up to
  ~1e3), and LAPACK through XLA and through torch round the inverse
  differently; the flow differs by ~1e-4 px, more at the far plane.
* the slice on GROUND_TRUTH flow, both processors reading the same ``.flo``
  files: every FrameResult field within 1e-5 but the FoE (0.05 px) and the
  rates (2e-3). The dense FoE is a consensus vote over line intersections
  that the two packages compute at fp32 with and without fused
  multiply-adds; on this scene a sample at the inlier threshold moves the
  FoE by up to 0.041 px, and the phi thresholds around it flip pixels worth
  1.1e-3 of a rate (measured on this sequence; on the synthetic sequence of
  tests/test_torch_processor.py both stay within 1e-5).
* the slice on FARNEBACK flow: flow agrees to ~1e-4 px between the packages,
  but on this 96x128 mock scene the Farneback FoE is ill-posed (it lies far
  from the GT FoE in both packages), so a frame whose vote flips between
  two consensus sets moves by several px in either. Held: the median over
  frames of the FoE difference within 0.5 px and of each rate's within 0.02
  (tests/test_torch_processor.py's tolerances), every other field of every
  frame within 1e-3.
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.core.flo import read_flow as j_read_flow
from mav_detection_tpu.data import airsim_flow as jaf
from mav_detection_tpu.data.dataset import imread as j_imread
from mav_detection_tpu.data.sim_data import SimDataset as JSimDataset
from mav_detection_tpu.data.sim_data import quat_to_euler_xyz as j_quat
from mav_detection_tpu.ops.flow import tuned_flow_params as j_tuned
from mav_detection_tpu.pipeline.processor import Processor as JProcessor
from mav_detection_tpu.sim.client import MockSimClient as JMock
from mav_detection_tpu.sim.client import Vector3 as JVector3
from mav_detection_tpu.sim.control import SimDataCollector as JCollector
from mav_detection_tpu.sim.sim_config import SimConfig as JSimConfig

from mav_detection_tpu_torch.cli.collect import main as collect_main
from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.core.flo import read_flow, write_flow
from mav_detection_tpu_torch.data import airsim_flow as taf
from mav_detection_tpu_torch.data.dataset import imread, read_pfm
from mav_detection_tpu_torch.data.sim_data import SimDataset, quat_to_euler_xyz
from mav_detection_tpu_torch.pipeline.processor import Processor
from mav_detection_tpu_torch.sim import MockSimClient, SimConfig, SimDataCollector, Vector3

torch.set_num_threads(1)

W, H = 128, 96
FOCAL = 70.0
RES = (W, H)
FLOW_TOL_PX = 2e-3
COLLECTION = {        # tests/test_sim_loop.py's, 8 captures
    "orientations": ["north"],
    "locations": {"testfield": {"x": 0.0, "y": 0.0, "z": -2.0}},
    "orbit_speed": [2.0],
    "global_speed": {"default": {"lin_x": 1.2, "sin_y": 0.0, "sin_z": 0.0}},
    "heights": {"low": 3.0},
    "radii": [15.0],
    "modes": ["collision"],
    "collision_angles": [10.0],
}
N_CAPTURES = 8
BATCH = 4
RATES = ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr")


@pytest.fixture
def rng():
    """A generator of this test's own (the repository-wide ``rng`` fixture is
    one stream shared with the JAX package's tests)."""
    return np.random.default_rng(11)


def manual_project(cam: np.ndarray, yaw: float, pts: np.ndarray) -> np.ndarray:
    """Independent NED pinhole projection: px = W/2 + f*right/fwd."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    rel = pts - cam
    fwd = rel[..., 0] * cy + rel[..., 1] * sy
    right = -rel[..., 0] * sy + rel[..., 1] * cy
    up = -rel[..., 2]
    return np.stack([W / 2 + FOCAL * right / fwd,
                     H / 2 - FOCAL * up / fwd], axis=-1)


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


# -------------------------------------- tests/test_airsim_flow.py on the port
class TestViewProj:
    def test_format_parse_roundtrip(self):
        vp = taf.pinhole_view_proj(np.array([120.0, -40.0, -500.0]), 0.7, FOCAL, RES)
        parsed = taf.parse_view_proj(
            {"Drone1": {"ue4": {"viewProjectionMatrix": taf.format_view_proj(vp)}}})
        np.testing.assert_allclose(parsed, vp, rtol=1e-6)
        np.testing.assert_array_equal(
            vp, jaf.pinhole_view_proj(np.array([120.0, -40.0, -500.0]), 0.7, FOCAL, RES))
        assert taf.format_view_proj(vp) == jaf.format_view_proj(vp)

    def test_world_to_screen_matches_manual_pinhole(self, rng):
        cam = np.array([50.0, -30.0, -400.0])
        yaw = 0.4
        vp = taf.pinhole_view_proj(cam, yaw, FOCAL, RES)
        pts = cam + rng.normal(0, 200.0, (40, 3)) + np.array([800.0, 0, 0])
        got = taf.world_to_screen(t32(vp), RES, t32(pts)).numpy()
        np.testing.assert_allclose(got, manual_project(cam, yaw, pts), atol=5e-3)

    def test_unproject_recovers_world_points(self, rng):
        cam = np.array([0.0, 0.0, -300.0])
        yaw = -0.2
        vp = taf.pinhole_view_proj(cam, yaw, FOCAL, RES)
        pts = cam + rng.normal(0, 150.0, (25, 3)) + np.array([900.0, 0, 0])
        screen = manual_project(cam, yaw, pts)
        depth = np.linalg.norm(pts - cam, axis=-1)
        rec = taf.screen_to_world(torch.linalg.inv(t32(vp)), RES, t32(screen),
                                  t32(depth)).numpy()
        np.testing.assert_allclose(rec, pts, atol=1.5)


class TestCalculateFlow:
    def _ground_flow_case(self, cam1, yaw1, cam2, yaw2):
        vp1 = taf.pinhole_view_proj(cam1, yaw1, FOCAL, RES)
        vp2 = taf.pinhole_view_proj(cam2, yaw2, FOCAL, RES)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        u = (xs - W / 2) / FOCAL
        v = (H / 2 - ys) / FOCAL
        cy, sy = np.cos(yaw1), np.sin(yaw1)
        dirs = (np.array([cy, sy, 0.0])[None, None]
                + u[..., None] * np.array([-sy, cy, 0.0])
                + v[..., None] * np.array([0.0, 0.0, -1.0]))
        dz = dirs[..., 2]
        with np.errstate(invalid="ignore"):
            t = np.where(dz > 1e-9, -cam1[2] / np.maximum(dz, 1e-9), np.nan)
        hit = cam1[None, None] + t[..., None] * dirs
        depth = t * np.linalg.norm(dirs, axis=-1)
        valid = np.isfinite(depth) & (depth < 5e4)
        flow = taf.calculate_flow(t32(vp1), t32(vp2), RES,
                                  t32(np.where(valid, depth, 1e4)), torch.zeros(3),
                                  torch.zeros((H, W), dtype=torch.uint8)).numpy()
        with np.errstate(invalid="ignore"):
            expected = manual_project(cam2, yaw2, hit) - np.stack([xs, ys], -1)
        return flow, expected, valid

    def test_pure_translation_ground_plane(self):
        cam1 = np.array([0.0, 0.0, -400.0])
        cam2 = cam1 + np.array([60.0, 10.0, 0.0])
        flow, expected, valid = self._ground_flow_case(cam1, 0.0, cam2, 0.0)
        m = valid & (np.linalg.norm(expected, axis=-1) < 25)
        epe = np.linalg.norm(flow - expected, axis=-1)[m]
        assert epe.mean() < 0.05, epe.mean()
        assert epe.max() < 0.3, epe.max()

    def test_pure_yaw_rotation(self):
        cam = np.array([0.0, 0.0, -400.0])
        dyaw = 0.02
        flow, expected, valid = self._ground_flow_case(cam, 0.0, cam, dyaw)
        m = valid & (np.linalg.norm(expected, axis=-1) < 25)
        epe = np.linalg.norm(flow - expected, axis=-1)[m]
        assert epe.mean() < 0.05, epe.mean()
        assert flow[H // 2, W // 2, 0] == pytest.approx(-FOCAL * dyaw, rel=0.05)

    def test_moving_target_correction(self):
        cam = np.array([0.0, 0.0, -400.0])
        vp = taf.pinhole_view_proj(cam, 0.0, FOCAL, RES)
        depth_val = 900.0
        seg = np.zeros((H, W), np.uint8)
        seg[30:40, 50:60] = 255
        disp = np.array([0.0, 40.0, -15.0])
        flow = taf.calculate_flow(t32(vp), t32(vp), RES, torch.full((H, W), depth_val),
                                  t32(disp), torch.from_numpy(seg)).numpy()
        assert np.abs(flow[seg == 0]).max() < 1e-2
        ys, xs = np.mgrid[30:40, 50:60].astype(np.float64)
        u = (xs - W / 2) / FOCAL
        v = (H / 2 - ys) / FOCAL
        dirs = np.stack([np.ones_like(u), u, -v], -1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pts = cam + dirs * depth_val + disp
        expected = manual_project(cam, 0.0, pts) - np.stack([xs, ys], -1)
        np.testing.assert_allclose(flow[30:40, 50:60], expected, atol=0.05)


def _two_captures(mock_cls, vec_cls):
    """Two mock captures 0.2 s apart, as tests/test_sim_loop.py flies them."""
    c = mock_cls(image_hw=(H, W), fov_deg=110)
    c.set_pose("Drone1", vec_cls(0.0, 0.0, -4.0), 0.1)
    c.set_pose("Drone2", vec_cls(8.0, 1.0, -3.5), 0.0)
    for d in c.drones.values():
        d.landed = False
    c.drones["Drone1"].velocity = np.array([2.0, 0.3, 0.0])
    c.drones["Drone2"].velocity = np.array([-1.0, 0.5, 0.0])
    snaps = []
    for _ in range(2):
        snaps.append(({r.image_type: r.data for r in c.capture("Drone1")},
                      {v: c.get_state(v) for v in ("Drone1", "Drone2")}))
        c.continue_for_time(0.2)
    return c, snaps


def test_calculate_flow_matches_jax_on_a_mock_capture():
    """The port's flow and the JAX package's on the same rendered pair, 96x128:
    within FLOW_TOL_PX (fp32 inverses), the target's pixels included."""
    c, ((r1, s1), (_, s2)) = _two_captures(MockSimClient, Vector3)
    vp1, vp2 = taf.parse_view_proj(s1), taf.parse_view_proj(s2)
    vel = s1["Drone2"]["ue4"]["linearVelocity"]
    disp = np.array([vel["X"], vel["Y"], vel["Z"]]) * 0.2 * 100.0
    depth = r1["depth"] * 100.0
    seg = r1["segmentation"][..., 0]
    assert seg.any()
    ref = np.asarray(jaf.calculate_flow(
        jnp.asarray(vp1, jnp.float32), jnp.asarray(vp2, jnp.float32), RES,
        jnp.asarray(depth, jnp.float32), jnp.asarray(disp, jnp.float32),
        jnp.asarray(seg)))
    got = taf.calculate_flow(t32(vp1), t32(vp2), RES, t32(depth), t32(disp),
                             torch.from_numpy(seg)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=FLOW_TOL_PX)
    packed = torch.from_numpy(taf.pack_pair(vp1, vp2, disp, depth, seg))
    np.testing.assert_array_equal(taf.calculate_flow_packed(packed, RES).numpy(), got)


def test_mock_client_renders_and_reports_as_the_reference():
    """The mock's captures and states are the JAX package's, exactly."""
    _, ours = _two_captures(MockSimClient, Vector3)
    _, theirs = _two_captures(JMock, JVector3)
    for (r_t, s_t), (r_j, s_j) in zip(ours, theirs):
        assert set(r_t) == set(r_j)
        for k in r_t:
            assert r_t[k].dtype == r_j[k].dtype
            np.testing.assert_array_equal(r_t[k], r_j[k])
        assert json.dumps(s_t, sort_keys=True) == json.dumps(s_j, sort_keys=True)


@pytest.mark.parametrize("mode", ["orbit", "collision", "line", "foe_demo"])
@pytest.mark.parametrize("observer", [True, False])
def test_sim_config_matches_the_reference(mode, observer):
    kw = dict(base_name="field", height_name="low", orientation="east",
              radius=15.0, ground_height=-2.0, orbit_speed=2.0,
              global_speed_name="default", mode=mode, collision_angle=30.0)
    ours = SimConfig(center=Vector3(1.0, 2.0, -5.0),
                     global_speed=Vector3(1.2, 0.0, 0.0),
                     **{**kw, "orientation": SimConfig.get_orientation("east"),
                        "mode": SimConfig.get_mode(mode)})
    theirs = JSimConfig(center=JVector3(1.0, 2.0, -5.0),
                        global_speed=JVector3(1.2, 0.0, 0.0),
                        **{**kw, "orientation": JSimConfig.get_orientation("east"),
                           "mode": JSimConfig.get_mode(mode)})
    assert str(ours) == str(theirs)
    a, b = ours.get_start_position(observer), theirs.get_start_position(observer)
    assert (a.x_val, a.y_val, a.z_val) == (b.x_val, b.y_val, b.z_val)


@pytest.mark.parametrize("q", [(0.0, 0.0, 0.3, 0.95), (0.1, -0.2, 0.05, 0.97),
                               (0.0, 0.0, 0.0, 0.0)])
def test_quat_to_euler_matches_the_reference(q):
    np.testing.assert_array_equal(quat_to_euler_xyz(*q), j_quat(*q))


@pytest.mark.parametrize("shape", [(24, 32), (24, 32, 3), (0, 0)])
def test_host_boxes_match_the_reference(shape, rng):
    """``get_simple_bounding_box`` (SimDataset's annotations) and
    ``box_array_to_rectangle`` are the reference's host functions."""
    from mav_detection_tpu.ops.image.boxes import box_array_to_rectangle as j_box_rect
    from mav_detection_tpu.ops.image.boxes import get_simple_bounding_box as j_box

    from mav_detection_tpu_torch.ops.image.boxes import (
        box_array_to_rectangle,
        get_simple_bounding_box,
    )

    img = np.zeros(shape, np.uint8)
    if img.size:
        img[5:11, 7:20] = rng.integers(40, 255, img[5:11, 7:20].shape)
    assert get_simple_bounding_box(img).__dict__ == j_box(img).__dict__
    for box in ([7, 5, 19, 10], [-1, -1, -1, -1]):
        assert box_array_to_rectangle(np.array(box)).__dict__ == \
            j_box_rect(np.array(box)).__dict__


# ------------------------------------------------- collector and SimDataset
def _collect(collector_cls, mock_cls, root):
    collector = collector_cls(mock_cls(image_hw=(H, W), fov_deg=100), COLLECTION,
                              root_data_dir=str(root), max_iterations=N_CAPTURES)
    collector.run()
    return os.path.relpath(collector.get_base_dir(collector.configs[0]), str(root))


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """The same collection flown by both packages' collectors."""
    tmp = tmp_path_factory.mktemp("collect")
    seq = _collect(SimDataCollector, MockSimClient, tmp / "port")
    assert _collect(JCollector, JMock, tmp / "jax") == seq
    return tmp, seq


def test_collectors_write_the_same_sequence(collected):
    """Images and segmentations decode equal, depths and state JSONs are
    equal, file for file."""
    tmp, seq = collected
    port, ref = tmp / "port" / seq, tmp / "jax" / seq
    names = sorted(str(p.relative_to(port)) for p in port.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(ref)) for p in ref.rglob("*") if p.is_file())
    assert len([n for n in names if n.startswith("images/")]) == N_CAPTURES
    for name in names:
        a, b = str(port / name), str(ref / name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(imread(a), j_imread(b), err_msg=name)
        elif name.endswith(".pfm"):
            np.testing.assert_array_equal(read_pfm(a), read_pfm(b), err_msg=name)
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name


@pytest.fixture(scope="module")
def sim_pair(collected, tmp_path_factory):
    """Copies of the port-collected sequence opened as SimDatasets by both
    packages (each synthesises its own GT flow and annotations)."""
    tmp, seq = collected
    roots = {k: tmp_path_factory.mktemp(f"sim_{k}") for k in ("port", "jax")}
    for root in roots.values():
        shutil.copytree(tmp / "port" / seq, root / seq)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SIMDATA_PATH", str(roots["port"]))
        port = SimDataset(sequence=seq, device="cpu")
        mp.setenv("SIMDATA_PATH", str(roots["jax"]))
        ref = JSimDataset(sequence=seq)
    finally:
        mp.undo()
    return port, ref


def test_sim_dataset_accessors_match(sim_pair):
    port, ref = sim_pair
    assert port.N == ref.N == N_CAPTURES
    assert [os.path.basename(p) for p in port.get_state_filenames()] == \
        [os.path.basename(p) for p in ref.get_state_filenames()]
    for i in range(port.N):
        assert port.get_time(i) == ref.get_time(i)
        assert port.get_gt_foe(i) == ref.get_gt_foe(i)
        np.testing.assert_array_equal(port.get_orientation(i), ref.get_orientation(i))
        np.testing.assert_array_equal(port.get_depth(i), ref.get_depth(i))
        if i:
            assert port.get_delta_time(i) == ref.get_delta_time(i)
            np.testing.assert_array_equal(port.get_angular_difference(i - 1, i),
                                          ref.get_angular_difference(i - 1, i))
        with open(f"{port.ann_path}/image_{i:05d}.txt") as a, \
                open(f"{ref.ann_path}/image_{i:05d}.txt") as b:
            assert a.read() == b.read()
        assert [r.__dict__ for r in port.get_annotation(i)] == \
            [r.__dict__ for r in ref.get_annotation(i)]


def test_gt_flow_files_match(sim_pair):
    """GT ``.flo`` files within FLOW_TOL_PX of the JAX writer's, and their
    colour images decoded equal wherever the flows round alike."""
    port, ref = sim_pair
    flos = sorted(glob.glob(f"{port.gt_of_path}/*.flo"))
    assert len(flos) == port.N - 1
    for i in range(port.N - 1):
        got = read_flow(f"{port.gt_of_path}/image_{i:05d}.flo")
        want = j_read_flow(f"{ref.gt_of_path}/image_{i:05d}.flo")
        assert got.shape == (H, W, 2) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=FLOW_TOL_PX, err_msg=f"pair {i}")
        vis_t = imread(f"{port.gt_of_vis_path}/image_{i:05d}.png")
        vis_j = j_imread(f"{ref.gt_of_vis_path}/image_{i:05d}.png")
        assert vis_t.shape == vis_j.shape
        assert np.abs(vis_t.astype(int) - vis_j.astype(int)).max() <= 1


def test_depth_visualisation_matches(sim_pair):
    port, ref = sim_pair
    port.create_depth_visualisation()
    ref.create_depth_visualisation()
    pngs = sorted(glob.glob(f"{port.depth_vis_path}/image_*.png"))
    assert len(pngs) == port.N
    for p in pngs:
        np.testing.assert_array_equal(
            imread(p), j_imread(os.path.join(ref.depth_vis_path, os.path.basename(p))))
    mtime = os.path.getmtime(pngs[0])
    port.create_depth_visualisation()
    assert os.path.getmtime(pngs[0]) == mtime


def test_get_gt_of_resizes_like_the_reference(sim_pair, rng):
    """A GT file at another size is resized to the capture size, on
    ``Dataset.device``, as the reference resizes it."""
    port, ref = sim_pair
    small = rng.normal(size=(H // 2, W // 2, 2)).astype(np.float32)
    idx = port.N           # an index past the sequence's own files
    for ds in (port, ref):
        write_flow(f"{ds.gt_of_path}/image_{idx:05d}.flo", small)
    got, want = port.get_gt_of(idx), np.asarray(ref.get_gt_of(idx))
    assert got.shape == want.shape == (H, W, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------------- slice
def jax_batch_samples(n_pairs, batch, n_samples, h, w):
    """The JAX processor's per-batch FoE draws (its key schedule)."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(0, n_pairs, batch):
        key, sub = jax.random.split(key)
        per = []
        for k in jax.random.split(sub, batch):
            ky, kx = jax.random.split(k)
            per.append(np.stack([
                np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
                np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
        out.append(np.stack(per))
    return out


def _vals(fr):
    return {k: np.asarray(v, np.float64) for k, v in fr.to_dict().items()}


def _run_both(sim_pair, flow_source, monkeypatch):
    port_ds, ref_ds = sim_pair
    seq = port_ds.sequence
    monkeypatch.setenv("SIMDATA_PATH", ref_ds.base_path)
    jproc = JProcessor(JRunConfig(dataset="simulation", sequence=seq,
                                  mode="FLOW_FOE_CLUSTERING", flow_source=flow_source,
                                  batch_size=BATCH))
    jproc.save_images = False
    jproc._farneback = j_tuned(H, W)
    ref = jproc.run_detection_foe()
    monkeypatch.setenv("SIMDATA_PATH", port_ds.base_path)
    proc = Processor(RunConfig(dataset="simulation", sequence=seq,
                               mode="FLOW_FOE_CLUSTERING", flow_source=flow_source,
                               batch_size=BATCH), device="cpu")
    proc.save_images = False
    got = proc.run_detection_foe(
        sample_yx=jax_batch_samples(port_ds.N - 1, BATCH, 1000, H, W))
    assert sorted(got) == sorted(ref) == list(range(port_ds.N - 1))
    jsons = glob.glob(f"{port_ds.results_path}/image_*.json")
    assert len(jsons) == port_ds.N - 1
    return ref, got


def test_slice_ground_truth_matches_jax(sim_pair, monkeypatch, tmp_path):
    """collect -> SimDataset -> FoE loop on GROUND_TRUTH flow, both packages
    reading the port's GT files; the FoE tracks the GT FoE as
    tests/test_sim_loop.py asks (median < 12 px)."""
    port_ds, ref_ds = sim_pair
    for i in range(port_ds.N - 1):
        shutil.copy(f"{port_ds.gt_of_path}/image_{i:05d}.flo",
                    f"{ref_ds.gt_of_path}/image_{i:05d}.flo")
    ref, got = _run_both(sim_pair, "GROUND_TRUTH", monkeypatch)
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            tol = 0.05 if k == "foe_dense" else 2e-3 if k in RATES else 1e-5
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=tol,
                                       equal_nan=True, err_msg=f"frame {i} {k}")
    err = np.array([np.subtract(fr.foe_dense, fr.foe_gt) for fr in got.values()])
    assert np.isfinite(err).all()
    assert (np.median(np.abs(err), axis=0) < 12).all(), err


def test_slice_farneback_matches_jax(sim_pair, monkeypatch):
    ref, got = _run_both(sim_pair, "FARNEBACK", monkeypatch)
    diffs = {k: [] for k in ("foe_dense",) + RATES}
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            if k in diffs:
                d = np.abs(g[k] - r[k])
                assert np.array_equal(np.isnan(g[k]), np.isnan(r[k])), (i, k)
                diffs[k].append(float(np.nanmax(d)) if np.isfinite(d).any() else 0.0)
            else:
                np.testing.assert_allclose(g[k], r[k], atol=1e-3, equal_nan=True,
                                           err_msg=f"frame {i} {k}")
    assert np.median(diffs["foe_dense"]) < 0.5, diffs["foe_dense"]
    for k in RATES:
        assert np.median(diffs[k]) < 0.02, (k, diffs[k])


def test_collect_cli_writes_a_sequence_the_dataset_opens(tmp_path, monkeypatch):
    """``python -m mav_detection_tpu_torch.cli.collect --mock`` reads
    settings.json from the working directory; the sequence it writes opens
    as a SimDataset that synthesises its GT flow."""
    monkeypatch.chdir(tmp_path)
    with open(tmp_path / "settings.json", "w") as f:
        json.dump({"collections": {"tiny": COLLECTION}}, f)
    collect_main(["--collection", "tiny", "--mock", "--image-size", "48x64",
                  "--data-dir", str(tmp_path / "data"), "--max-iterations", "3"])
    seqs = [d for d in glob.glob(str(tmp_path / "data" / "*")) if "testfield" in d]
    assert len(seqs) == 1
    monkeypatch.setenv("SIMDATA_PATH", str(tmp_path / "data"))
    ds = SimDataset(sequence=os.path.basename(seqs[0]), device="cpu")
    assert ds.N == 3 and ds.capture_shape == (48, 64, 3)
    assert len(glob.glob(f"{ds.gt_of_path}/*.flo")) == 2
    with pytest.raises(SystemExit):
        collect_main(["--collection", "nope", "--mock"])

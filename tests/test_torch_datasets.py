"""The port's dataset readers held to the JAX package's on sequences written
here: MIDGARD (a synthetic sequence materialised by the JAX package, so the
port reads Pillow-written PNGs), VisDrone and experiment layouts (the latter
with a generated GPS / IMU CSV pair), ``make_dataset``, the preprocessing
hook and its copies, the depth-less divergence of the scan engines, and the
MIDGARD read-back through both processors.

Draws are the JAX processors' (its per-batch and per-transition keys),
rebuilt here and handed to the port as ``sample_yx``. Sky masks: the port
runs its SkyUNet on frames without HRNet output and caches the masks as
HRNet-layout PNGs, which the JAX side then reads, so both use the same
masks.
"""
import glob
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from mav_detection_tpu.core.config import DatasetType as JDatasetType
from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.data import make_dataset as j_make_dataset
from mav_detection_tpu.data import preprocessing as jprep
from mav_detection_tpu.data.dataset import imread as j_imread
from mav_detection_tpu.data.experiment import ExperimentDataset as JExperiment
from mav_detection_tpu.data.midgard import MidgardDataset as JMidgard
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.data.vis_drone import VisDroneDataset as JVisDrone
from mav_detection_tpu.ops.flow import tuned_flow_params as j_tuned
from mav_detection_tpu.pipeline.processor import Processor as JProcessor

from mav_detection_tpu_torch.core.config import DatasetType, RunConfig
from mav_detection_tpu_torch.core.flo import write_flow
from mav_detection_tpu_torch.data import (
    ExperimentDataset,
    MidgardDataset,
    SimDataset,
    SyntheticDataset,
    VisDroneDataset,
    make_dataset,
)
from mav_detection_tpu_torch.data import preprocessing as tprep
from mav_detection_tpu_torch.data.dataset import imread
from mav_detection_tpu_torch.pipeline.processor import Processor

torch.set_num_threads(1)

SMALL = dict(height=48, width=64, n_frames=6, expansion=0.08, foe=(30.0, 20.0),
             drone_radius=5, drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))
MIDGARD_SEQ = "countryside-natural/north-narrow"
BATCH = 2
RATES = ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr")


@pytest.fixture
def rng():
    """A generator of this test's own (the repository-wide ``rng`` fixture is
    one stream shared with the JAX package's tests)."""
    return np.random.default_rng(21)


def materialize_midgard(root, n_frames=SMALL["n_frames"]) -> str:
    """A MIDGARD-layout sequence at ``root`` (default sequence name), written
    by the JAX package's synthetic generator."""
    JSynth(sequence=MIDGARD_SEQ, params=JParams(**dict(SMALL, n_frames=n_frames)),
           materialize_to=str(root))
    return os.path.join(str(root), MIDGARD_SEQ)


@pytest.fixture(scope="module")
def midgard_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("midgard")
    materialize_midgard(root)
    return root


def _rects(rects):
    return [r.__dict__ for r in rects]


def _hold_readers(port, ref):
    """Frames, annotations, times, dts, angular differences, depths,
    segmentations and GT flow equal between the two readers."""
    assert port.get_default_sequence() == ref.get_default_sequence()
    assert (port.N, port.capture_shape, port.seq_path) == \
        (ref.N, ref.capture_shape, ref.seq_path)
    np.testing.assert_array_equal(port.resolution, ref.resolution)
    for i in range(port.N):
        np.testing.assert_array_equal(port.get_frame(i), ref.get_frame(i))
        np.testing.assert_array_equal(port.get_segmentation(i), ref.get_segmentation(i))
        assert _rects(port.get_annotation(i)) == _rects(ref.get_annotation(i))
        assert port.get_time(i) == ref.get_time(i)
        assert port.get_delta_time(i) == ref.get_delta_time(i)
        np.testing.assert_array_equal(port.get_angular_difference(max(i - 1, 0), i),
                                      ref.get_angular_difference(max(i - 1, 0), i))
        for get in ("get_depth", "get_gt_of"):
            a, b = getattr(port, get)(i), getattr(ref, get)(i)
            assert (a is None) == (b is None), get
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert port.get_gt_foe(i) == ref.get_gt_foe(i)
        assert port.get_flow_path(i) == ref.get_flow_path(i)


def test_midgard_reader_matches(midgard_root, monkeypatch):
    monkeypatch.setenv("MIDGARD_PATH", str(midgard_root))
    port = MidgardDataset(device="cpu")
    ref = JMidgard()
    assert port.sequence == ref.sequence == MIDGARD_SEQ
    _hold_readers(port, ref)


def test_vis_drone_reader_matches(midgard_root, tmp_path, monkeypatch):
    """VisDrone keeps its frames directly under sequences/<seq>/."""
    seq = tmp_path / "sequences" / "uav0000244_01440_v"
    seq.mkdir(parents=True)
    for p in sorted(glob.glob(f"{midgard_root}/{MIDGARD_SEQ}/images/image_*.png")):
        shutil.copy(p, seq)
    monkeypatch.setenv("VIS_DRONE_PATH", str(tmp_path))
    port, ref = VisDroneDataset(device="cpu"), JVisDrone()
    assert port.img_path == ref.img_path == str(seq)
    _hold_readers(port, ref)


def _experiment_layout(root, midgard_root, rng, n_frames=SMALL["n_frames"]):
    """images/ plus a GPS (5 Hz) and IMU (50 Hz) CSV pair spanning the
    reference's alignment offset, with jittered stamps."""
    seq = root / "moving-sample"
    (seq / "images").mkdir(parents=True)
    (seq / "states").mkdir()
    for p in sorted(glob.glob(f"{midgard_root}/{MIDGARD_SEQ}/images/image_*.png"))[:n_frames]:
        shutil.copy(p, seq / "images")
    t0 = 1.6e9
    for name, hz, cols in (("vn_gps_log.csv", 5, 8), ("vn_imu_log.csv", 50, 12)):
        t = t0 + np.arange(0.0, 4 * 60 + 54 + 16, 1.0 / hz)
        t = t + rng.uniform(-0.2, 0.2, t.shape) / hz
        data = rng.normal(size=(t.size, cols))
        data[:, 2] = t
        header = ",".join(f"c{k}" for k in range(cols))
        np.savetxt(seq / "states" / name, data, delimiter=",", header=header,
                   comments="", fmt="%.9f")
    return root


def test_experiment_reader_matches(midgard_root, tmp_path, rng, monkeypatch):
    """Alignment indices and the gyro integral bit-equal; every accessor
    equal."""
    monkeypatch.setenv("EXPERIMENT_PATH",
                       str(_experiment_layout(tmp_path, midgard_root, rng)))
    port, ref = ExperimentDataset(device="cpu"), JExperiment()
    for key in ("video_gps_indices", "video_imu_indices", "_gyro_cumsum",
                "gps_log", "imu_log"):
        a, b = getattr(port, key), getattr(ref, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert port.fps == ref.fps
    assert len(set(port.video_imu_indices.tolist())) == port.N
    for i in range(port.N):
        np.testing.assert_array_equal(port.get_gps_state(i), ref.get_gps_state(i))
        np.testing.assert_array_equal(port.get_imu_state(i), ref.get_imu_state(i))
        for j in range(port.N):
            np.testing.assert_array_equal(port.get_angular_difference(i, j),
                                          ref.get_angular_difference(i, j))
    _hold_readers(port, ref)


@pytest.mark.parametrize("dtype,cls", [
    (DatasetType.MIDGARD, MidgardDataset), (DatasetType.SIMULATION, SimDataset),
    (DatasetType.VIS_DRONE, VisDroneDataset),
    (DatasetType.EXPERIMENT, ExperimentDataset),
    (DatasetType.SYNTHETIC, SyntheticDataset)], ids=lambda v: getattr(v, "name", ""))
def test_make_dataset_gives_each_class(dtype, cls, midgard_root, tmp_path, rng,
                                       monkeypatch):
    frames = sorted(glob.glob(f"{midgard_root}/{MIDGARD_SEQ}/images/image_*.png"))
    monkeypatch.setenv("MIDGARD_PATH", str(midgard_root))
    vis = tmp_path / "vis" / "sequences" / "uav0000244_01440_v"
    vis.mkdir(parents=True)
    sim = tmp_path / "sim" / "citypark-stationary" / \
        "soccerfield-north-low-2.5-10-default" / "images"
    sim.mkdir(parents=True)
    for p in frames[:3]:
        shutil.copy(p, vis)
        shutil.copy(p, sim)
    monkeypatch.setenv("VIS_DRONE_PATH", str(tmp_path / "vis"))
    monkeypatch.setenv("SIMDATA_PATH", str(tmp_path / "sim"))
    monkeypatch.setenv("EXPERIMENT_PATH", str(
        _experiment_layout(tmp_path / "exp", midgard_root, rng, 3)))
    monkeypatch.delenv("SYNTHETIC_PATH", raising=False)
    ds = make_dataset(dtype, device="cpu")
    assert type(ds) is cls
    assert str(torch.device(ds.device)) == "cpu"
    ref = j_make_dataset(JDatasetType[dtype.name])
    assert type(ref).__name__ == cls.__name__ and ref.N == ds.N


def test_make_dataset_refuses_other_types():
    with pytest.raises(ValueError, match="Invalid dataset type"):
        make_dataset("midgard")
    with pytest.raises(ValueError, match="Invalid dataset type"):
        j_make_dataset("midgard")


def test_stray_jpg_frames_raise_naming_the_step(midgard_root, tmp_path, monkeypatch):
    """A divergence by design: the reference converts .jpg frames to PNG
    (``jpgs_to_pngs``); the port has no JPEG decoder and says so."""
    shutil.copytree(f"{midgard_root}/{MIDGARD_SEQ}", tmp_path / MIDGARD_SEQ)
    (tmp_path / MIDGARD_SEQ / "images" / "frame_00007.jpg").write_bytes(b"\xff\xd8")
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    with pytest.raises(NotImplementedError, match="jpgs_to_pngs.*JPEG decoder"):
        MidgardDataset(device="cpu")


def test_recording_without_ffmpeg_ends_as_the_reference(tmp_path, monkeypatch):
    """A sequence holding only recording.mp4 on a machine without ffmpeg:
    no frame is recovered and both packages raise FileNotFoundError."""
    (tmp_path / MIDGARD_SEQ).mkdir(parents=True)
    (tmp_path / MIDGARD_SEQ / "recording.mp4").write_bytes(b"\x00" * 16)
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    for prep in (jprep, tprep):
        monkeypatch.setattr(prep.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError, match="no frames found"):
        JMidgard()
    with pytest.raises(FileNotFoundError, match="no frames found"):
        MidgardDataset(device="cpu")
    assert not tprep.video_to_images(str(tmp_path / MIDGARD_SEQ / "recording.mp4"),
                                     str(tmp_path / "x" / "image_%5d.png"))
    assert not tprep.images_to_video(str(tmp_path / "x" / "image_%5d.png"),
                                     str(tmp_path / "x.mp4"))


def _tree(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(f"{root}/**", recursive=True)
                  if os.path.isfile(p))


def test_preprocessing_copies_give_the_same_trees(midgard_root, tmp_path):
    """``renormalize_indices`` and ``create_half_res_images`` of both
    packages give the same files; PNGs decode equal."""
    frames = sorted(glob.glob(f"{midgard_root}/{MIDGARD_SEQ}/images/image_*.png"))
    roots = {}
    for name, prep in (("port", tprep), ("jax", jprep)):
        d = tmp_path / name / "images"
        d.mkdir(parents=True)
        for k, p in zip((3, 11, 12, 40), frames):
            shutil.copy(p, d / f"image_{k:05d}.png")
        (d / "image_00007.txt").write_text("7")
        assert prep.renormalize_indices(str(d)) == 5
        assert prep.create_half_res_images(str(d), str(tmp_path / name / "half")) == 4
        assert prep.create_half_res_images(str(d), str(tmp_path / name / "half")) == 0
        roots[name] = tmp_path / name
    assert _tree(roots["port"]) == _tree(roots["jax"])
    assert (roots["port"] / "images" / "image_00001.txt").read_text() == "7"
    for rel in _tree(roots["port"]):
        if rel.endswith(".png"):
            np.testing.assert_array_equal(imread(str(roots["port"] / rel)),
                                          j_imread(str(roots["jax"] / rel)))
    assert tprep.jpgs_to_pngs(str(roots["port"] / "images")) == 0


def test_path_helpers_match(monkeypatch):
    monkeypatch.setenv("KITTI_PATH", "/k")
    monkeypatch.setenv("CENEK_PATH", "/c")
    assert tprep.get_kitti_image_dir("05") == jprep.get_kitti_image_dir("05")
    assert tprep.get_cenek_paths("s", 2) == jprep.get_cenek_paths("s", 2)


def test_validate_sky_segment_matches(midgard_root, rng, monkeypatch):
    monkeypatch.setenv("MIDGARD_PATH", str(midgard_root))
    port, ref = MidgardDataset(device="cpu"), JMidgard()
    depth = port.get_depth(0)
    for mask in (depth > 50, rng.random(depth.shape) > 0.5):
        assert port.validate_sky_segment(mask, depth) == \
            ref.validate_sky_segment(mask, depth)


# ------------------------------------------------- processors on MIDGARD
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


def jax_scan_samples(T, n_samples, h, w):
    """(T-1, 2N, 2) (y, x) indices the reference's scan draws."""
    key = jax.random.PRNGKey(0)
    out = []
    for t in range(1, T):
        ky, kx = jax.random.split(jax.random.fold_in(key, t))
        out.append(np.stack([
            np.asarray(jax.random.randint(ky, (2 * n_samples,), 0, h)),
            np.asarray(jax.random.randint(kx, (2 * n_samples,), 0, w))], -1))
    return np.stack(out)


def _vals(fr):
    return {k: np.asarray(v, np.float64) for k, v in fr.to_dict().items()}


@pytest.fixture(scope="module")
def midgard_runs(tmp_path_factory):
    """A MIDGARD sequence with ``.flo`` files in its flow directory, read
    back by both processors on PRECOMPUTED and FARNEBACK flow. The port runs
    first: its SkyUNet masks are cached for the JAX side."""
    root = tmp_path_factory.mktemp("midgard_runs")
    seq = materialize_midgard(root)
    flow_dir = os.path.join(seq, "images", "output", "inference", "run.epoch-0-flow-field")
    os.makedirs(flow_dir)
    flows = JSynth(params=JParams(**SMALL)).flows
    for i, f in enumerate(flows):
        write_flow(os.path.join(flow_dir, f"{i:06d}.flo"), f)
    h, w = SMALL["height"], SMALL["width"]
    draws = jax_batch_samples(SMALL["n_frames"] - 1, BATCH, 1000, h, w)
    mp = pytest.MonkeyPatch()
    mp.setenv("MIDGARD_PATH", str(root))
    out = {}
    try:
        for src in ("PRECOMPUTED", "FARNEBACK"):
            proc = Processor(RunConfig(dataset="midgard", flow_source=src,
                                       batch_size=BATCH), device="cpu")
            proc.save_images = False
            port = proc.run_detection_foe(sample_yx=draws)
            jproc = JProcessor(JRunConfig(dataset="midgard", flow_source=src,
                                          batch_size=BATCH))
            jproc.save_images = False
            jproc._farneback = j_tuned(h, w)
            out[src] = (jproc.run_detection_foe(), port)
    finally:
        mp.undo()
    out["seq"] = seq
    return out


def test_midgard_precomputed_json_matches(midgard_runs):
    """Both processors read the same .flo files through the MIDGARD reader:
    every FrameResult field within 1e-5."""
    ref, got = midgard_runs["PRECOMPUTED"]
    assert sorted(got) == sorted(ref) == list(range(SMALL["n_frames"] - 1))
    assert len(glob.glob(f"{midgard_runs['seq']}/half-res-images/hrnet/*.png")) == \
        SMALL["n_frames"] - 1
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=f"frame {i} {k}")


def test_midgard_farneback_json_matches(midgard_runs):
    """FARNEBACK on the MIDGARD read-back: FoE within 0.5 px, rates within
    0.02, everything else within 1e-3 (tests/test_torch_processor.py)."""
    ref, got = midgard_runs["FARNEBACK"]
    assert sorted(got) == sorted(ref)
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            tol = 0.5 if k == "foe_dense" else 0.02 if k in RATES else 1e-3
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_depthless_sequence_scan_engines_diverge_by_design(tmp_path, monkeypatch):
    """A MIDGARD sequence without depths/. The reference's scan engine stores
    a NaN depth plane (no pixel is sky ground truth: sky_tpr NaN, sky_fpr the
    share of pixels masked as sky); the port's engines, like both batch
    engines, a ones plane (every pixel is sky ground truth: sky_tpr the share
    masked as sky, sky_fpr NaN). Every other field agrees within the scan
    tolerances of tests/test_torch_temporal.py (FoE 0.5 px, rates 0.02,
    else 1e-3), and the port's batch engine gives the same sky rates."""
    seq = materialize_midgard(tmp_path)
    shutil.rmtree(os.path.join(seq, "depths"))
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    h, w, T = SMALL["height"], SMALL["width"], SMALL["n_frames"]
    proc = Processor(RunConfig(dataset="midgard", flow_source="FARNEBACK",
                               engine="scan", batch_size=BATCH), device="cpu")
    got = proc.run_detection_foe(sample_yx=jax_scan_samples(T, 1000, h, w))
    batch = Processor(RunConfig(dataset="midgard", flow_source="FARNEBACK",
                                batch_size=BATCH), device="cpu")
    batch.save_images = False
    got_batch = batch.run_detection_foe()
    jproc = JProcessor(JRunConfig(logger=logging.getLogger("t"), dataset="midgard",
                                  flow_source="FARNEBACK", engine="scan",
                                  headless=True))
    jproc._farneback = j_tuned(h, w)
    ref = jproc.run_detection_foe()
    assert sorted(got) == sorted(ref) == sorted(got_batch) == list(range(T - 1))
    for i in ref:
        sky_share = float(np.mean(proc.dataset.get_sky_segmentation(i)))
        assert np.isnan(ref[i].sky_tpr) and ref[i].sky_fpr == pytest.approx(sky_share)
        for fr in (got[i], got_batch[i]):
            assert fr.sky_tpr == pytest.approx(sky_share) and np.isnan(fr.sky_fpr)
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            if k in ("sky_tpr", "sky_fpr"):
                continue
            tol = 0.5 if k == "foe_dense" else 0.02 if k in RATES else 1e-3
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")

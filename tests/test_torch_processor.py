"""The port's Processor held to the JAX package's on a synthetic 48x64
sequence: 6 frames, batch 2, so the third batch is a padded tail; the
homography branch on the 120x160 set of tests/test_pipeline.py.

The JAX processor draws FoE samples from per-batch keys (PRNGKey(0), one
split per batch, one key per frame) and k-means centers from per-frame keys;
the tests rebuild those draws and feed them to the port through
``run_detection_foe(sample_yx=...)`` and
``run_detection_homography(kmeans_init=...)``.
"""
import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.ops.flow import tuned_flow_params as j_tuned
from mav_detection_tpu.pipeline.processor import Processor as JProcessor

from mav_detection_tpu_torch.cli.main import main as cli_main
from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.data.dataset import imread, imwrite
from mav_detection_tpu_torch.pipeline.processor import Processor, _edge_pad_batch

# Tiny shapes: one intra-op thread, so that test workers running side by side
# do not oversubscribe the cores (thousands of small ops, each a thread barrier).
torch.set_num_threads(1)

SMALL = dict(height=48, width=64, n_frames=6, expansion=0.08, foe=(30.0, 20.0),
             drone_radius=5, drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))
BATCH = 2
N_PAIRS = SMALL["n_frames"] - 1


def jax_batch_samples(n_pairs, batch, n_samples, h, w):
    """The JAX processor's per-batch FoE draws (processor.py key schedule)."""
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


def run_jax(flow_source, farneback=None, seq=SMALL):
    cfg = JRunConfig(dataset="synthetic", flow_source=flow_source, batch_size=BATCH)
    cfg.get_dataset = lambda **_: JSynth(params=JParams(**seq))
    proc = JProcessor(cfg)
    proc.save_images = False
    if farneback is not None:
        proc._farneback = farneback
    return proc.run_detection_foe()


def port_processor(flow_source, seq=SMALL, **cfg_kw):
    cfg = RunConfig(dataset="synthetic", flow_source=flow_source,
                    batch_size=BATCH, **cfg_kw)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(**seq))
    return Processor(cfg, device="cpu")


def run_port(flow_source, seq=SMALL):
    syx = jax_batch_samples(seq["n_frames"] - 1, BATCH, 1000, seq["height"],
                            seq["width"])
    return port_processor(flow_source, seq).run_detection_foe(sample_yx=syx)


def _vals(fr):
    return {k: np.asarray(v, np.float64) for k, v in fr.to_dict().items()}


def test_precomputed_json_fields_match():
    """(a) Both processors read the same GT flow: every JSON field within
    1e-5 (relative for the FoE, whose line intersections XLA computes with
    fused multiply-adds)."""
    ref, got = run_jax("PRECOMPUTED"), run_port("PRECOMPUTED")
    assert sorted(got) == sorted(ref) == list(range(N_PAIRS))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=f"frame {i} {k}")


def test_farneback_json_fields_match():
    """(b) Both run the tuned fused-iteration Farneback (the JAX side's
    kernel in interpret mode). Flow differs at fp level (XLA's FMAs, matmul
    order), which can flip pixels sitting on a threshold: FoE within 0.5 px,
    rates within 0.02, everything else within 1e-3."""
    ref = run_jax("FARNEBACK", farneback=j_tuned(SMALL["height"], SMALL["width"]))
    got = run_port("FARNEBACK")
    assert sorted(got) == sorted(ref) == list(range(N_PAIRS))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            tol = {"foe_dense": 0.5, "tpr": 0.02, "fpr": 0.02, "tpr_fixed": 0.02,
                   "fpr_fixed": 0.02}.get(k, 1e-3)
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_json_written_and_tail_padded(tmp_path):
    proc = port_processor("FARNEBACK")
    proc.dataset.seq_path = str(tmp_path)
    proc.dataset.results_path = str(tmp_path / "results")
    res = proc.run_detection_foe()
    assert sorted(res) == list(range(N_PAIRS))       # padded lanes dropped
    for i, fr in res.items():
        text = (tmp_path / "results" / f"image_{i:05d}.json").read_text()
        assert text == fr.to_json()
        assert json.dumps(FrameResult.from_dict(json.loads(text)).to_dict()) == \
            json.dumps(fr.to_dict())
    assert proc.tracer.counts["flow"] == 3


def test_seeded_draw_repeats():
    proc = port_processor("PRECOMPUTED")
    a = {i: fr.foe_dense for i, fr in proc.run_detection_foe().items()}
    b = {i: fr.foe_dense for i, fr in proc.run_detection_foe().items()}
    assert a == b


def test_edge_pad_batch():
    arr = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(_edge_pad_batch(arr, 2)[3:], [[4, 5], [4, 5]])
    assert _edge_pad_batch(arr, 0) is arr


@pytest.mark.parametrize("kw,attr", [
    (dict(engine="scan", devices=2), None), (dict(engine="chunked", devices=2), None),
    (dict(engine="spatial"), None), (dict(devices=2), None),
    (dict(flow_source="RAFT", engine="scan"), "run_detection_foe"),
    (dict(flow_source="RAFT", engine="scan"), "run_detection")])
def test_unported_paths_raise(kw, attr):
    """Multi-device runs construct with their ranks to spawn and the batch
    raised to them (tests/test_torch_parallel*.py run them); the spatial
    engine without devices raises the reference's ValueError at
    construction; the RAFT source on the scan engine raises the reference's
    ValueError when asked for flow (the scan body computes Farneback
    flow)."""
    kw = dict(kw)
    flow_source = kw.pop("flow_source", "FARNEBACK")
    if attr is None:
        if "devices" not in kw:
            with pytest.raises(ValueError, match="requires --devices > 1"):
                port_processor(flow_source, **kw)
            return
        proc = port_processor(flow_source, **kw)
        assert proc._ranks == 2 and proc.mesh is None
        assert proc.batch_size == max(BATCH, 2)
        return
    proc = port_processor(flow_source, **kw)
    with pytest.raises(ValueError, match="--flow-source RAFT is not supported there"):
        getattr(proc, attr)()


def test_scan_engine_is_ported_and_chunked_needs_devices():
    """``engine="scan"`` runs (one FrameResult per transition); ``chunked``
    on one device raises the reference's ValueError."""
    res = port_processor("FARNEBACK", engine="scan").run_detection()
    assert sorted(res) == list(range(N_PAIRS))
    assert all(np.isfinite(fr.foe_dense).all() for fr in res.values())
    with pytest.raises(ValueError, match="chunked requires --devices > 1"):
        port_processor("FARNEBACK", engine="chunked").run_detection()


def test_cli_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SYNTHETIC_PATH", str(tmp_path))
    cli_main(["--dataset", "synthetic", "--flow-source", "FARNEBACK",
              "--headless", "--device", "cpu", "--batch-size", "8",
              "--foe-samples", "200"])
    results = sorted((tmp_path).rglob("results/image_*.json"))
    assert len(results) == SyntheticParams().n_frames - 1


@pytest.mark.parametrize("argv", [
    ["--engine", "spatial"], ["--engine", "chunked"], ["--devices", "2"]])
def test_cli_unported_flags_raise(argv, monkeypatch):
    """The multi-device flags are ported: the CLI hands them to the
    Processor, which raises the reference's ValueErrors for the spatial and
    chunked engines without --devices."""
    import mav_detection_tpu_torch.cli.main as tmain

    base = ["--dataset", "synthetic", "--device", "cpu"]
    seen = {}
    monkeypatch.setattr(tmain, "execute",
                        lambda config, device: seen.update(config=config, device=device))
    cli_main(base + argv)
    assert seen["device"] == "cpu"
    assert seen["config"].devices == (2 if "--devices" in argv else 0)
    if "--engine" in argv:
        monkeypatch.undo()
        with pytest.raises(ValueError, match="requires --devices > 1"):
            cli_main(base + argv + ["--flow-source", "FARNEBACK", "--headless"])


def _dataset_layout(name, root):
    """Env var and sequence of a 4-frame sequence of dataset ``name`` written
    under ``root``: the synthetic frames in MIDGARD / VisDrone / experiment
    layout (the latter with a GPS / IMU CSV pair), or a mock collection."""
    if name == "simulation":
        from mav_detection_tpu_torch.sim import MockSimClient, SimDataCollector

        collection = {
            "orientations": ["north"], "locations": {"field": {"x": 0.0, "y": 0.0, "z": -2.0}},
            "orbit_speed": [2.0], "heights": {"low": 3.0}, "radii": [15.0],
            "global_speed": {"default": {"lin_x": 1.2, "sin_y": 0.0, "sin_z": 0.0}},
            "modes": ["collision"], "collision_angles": [10.0]}
        col = SimDataCollector(MockSimClient(image_hw=(48, 64)), collection,
                               root_data_dir=str(root), max_iterations=4)
        col.run()
        return "SIMDATA_PATH", os.path.relpath(col.get_base_dir(col.configs[0]), root)
    env, img_dir = {
        "midgard": ("MIDGARD_PATH", "countryside-natural/north-narrow/images"),
        "vis_drone": ("VIS_DRONE_PATH", "sequences/uav0000244_01440_v"),
        "experiment": ("EXPERIMENT_PATH", "moving-sample/images")}[name]
    os.makedirs(root / img_dir)
    for i, frame in enumerate(SyntheticDataset(params=SyntheticParams(
            **dict(SMALL, n_frames=4))).frames):
        imwrite(str(root / img_dir / f"image_{i:05d}.png"), frame)
    if name == "experiment":
        os.makedirs(root / "moving-sample" / "states")
        t = 1.6e9 + np.arange(0.0, 320.0, 0.1)
        for log in ("vn_gps_log.csv", "vn_imu_log.csv"):
            data = np.zeros((t.size, 9))
            data[:, 2], data[:, 6:9] = t, 0.01
            np.savetxt(root / "moving-sample" / "states" / log, data, delimiter=",",
                       header=",".join("c" * 9), comments="")
    return env, ""


@pytest.mark.parametrize("dataset", ["midgard", "simulation", "vis_drone", "experiment"])
def test_cli_dataset_runs_on_cpu(dataset, tmp_path, monkeypatch):
    """``--dataset`` of each reader with the CLI's other defaults
    (PRECOMPUTED, which falls back to Farneback without .flo files; the batch
    engine; sky masks from the SkyUNet): one finite-FoE FrameResult JSON per
    pair in the sequence's results/."""
    monkeypatch.chdir(tmp_path)
    env, seq = _dataset_layout(dataset, tmp_path)
    monkeypatch.setenv(env, str(tmp_path))
    argv = ["--dataset", dataset, "--headless", "--device", "cpu",
            "--batch-size", "2", "--foe-samples", "200"]
    cli_main(argv + (["--sequence", seq] if seq else []))
    results = sorted(tmp_path.rglob("results/image_*.json"))
    assert len(results) == 3
    for r in results:
        fr = FrameResult.from_json_file(str(r))
        assert np.isfinite(fr.foe_dense).all()
    logging.getLogger("main").setLevel(logging.INFO)
    logging.getLogger("mav_detection_tpu_torch").setLevel(logging.NOTSET)


def test_cli_engine_scan_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SYNTHETIC_PATH", str(tmp_path))
    cli_main(["--dataset", "synthetic", "--flow-source", "FARNEBACK", "--engine",
              "SCAN", "--headless", "--device", "cpu", "--foe-samples", "200"])
    results = sorted((tmp_path).rglob("results/image_*.json"))
    assert len(results) == SyntheticParams().n_frames - 1


# ------------------------------------------------ flow sources (FoE branch)
def test_ground_truth_json_fields_match():
    """GROUND_TRUTH reads the same flow on both sides: every JSON field
    within 1e-5, as PRECOMPUTED."""
    ref, got = run_jax("GROUND_TRUTH"), run_port("GROUND_TRUTH")
    assert sorted(got) == sorted(ref) == list(range(N_PAIRS))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=f"frame {i} {k}")


def test_ground_truth_reads_flo_files_from_disk(tmp_path):
    """A materialised sequence serves GROUND_TRUTH from optical-flow/*.flo."""
    cfg = RunConfig(dataset="synthetic", flow_source="GROUND_TRUTH", batch_size=BATCH)
    cfg.get_dataset = lambda **_: SyntheticDataset(
        params=SyntheticParams(**SMALL), materialize_to=str(tmp_path))
    proc = Processor(cfg, device="cpu")
    proc.dataset.gt_of_path = os.path.join(proc.dataset.seq_path, "optical-flow")
    proc.dataset.get_gt_of = None            # the files must be what is read
    flow = proc._read_flow([0, 1], cfg.flow_source)
    np.testing.assert_array_equal(flow, np.stack(proc.dataset.flows[:2]))


def test_lucas_kanade_json_fields_match():
    """LUCAS_KANADE densifies sparse tracks on both sides (within 2e-2 px
    of each other, see test_torch_lucas_kanade.py): FoE within 1 px, rates
    within 0.02, everything else within 1e-3."""
    ref, got = run_jax("LUCAS_KANADE"), run_port("LUCAS_KANADE")
    assert sorted(got) == sorted(ref) == list(range(N_PAIRS))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            tol = {"foe_dense": 1.0, "tpr": 0.02, "fpr": 0.02, "tpr_fixed": 0.02,
                   "fpr_fixed": 0.02}.get(k, 1e-3)
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_lucas_kanade_tail_lanes_are_not_computed(monkeypatch):
    """The padded lanes of a tail batch repeat the last real lane's flow."""
    from mav_detection_tpu_torch.pipeline import processor as pmod

    calls = []
    real = pmod.lk_dense_flow
    monkeypatch.setattr(pmod, "lk_dense_flow",
                        lambda a, b: calls.append(1) or real(a, b))
    res = port_processor("LUCAS_KANADE").run_detection_foe()
    assert sorted(res) == list(range(N_PAIRS)) and len(calls) == N_PAIRS


# ------------------------------------------------------------ debug images
IMAGE_DIRS = ("result-images", "derotated", "phi", "processed")


def _materialised(cls, params_cls, cfg_cls, tmp, **cfg_kw):
    cfg = cfg_cls(dataset="synthetic", flow_source="PRECOMPUTED",
                  batch_size=BATCH, **cfg_kw)
    cfg.get_dataset = lambda **_: cls(params=params_cls(**SMALL),
                                  materialize_to=str(tmp))
    return cfg


@pytest.fixture(scope="module")
def artifact_runs(tmp_path_factory):
    """Both processors with save_images on (its default), each over its own
    materialised copy of the sequence."""
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jproc = JProcessor(_materialised(JSynth, JParams, JRunConfig, jdir))
    assert jproc.save_images
    jproc.run_detection_foe()
    tproc = Processor(_materialised(SyntheticDataset, SyntheticParams, RunConfig,
                                    tdir), device="cpu")
    assert tproc.save_images
    syx = jax_batch_samples(N_PAIRS, BATCH, 1000, SMALL["height"], SMALL["width"])
    tproc.run_detection_foe(sample_yx=syx)
    return jproc.dataset.seq_path, tproc.dataset.seq_path, tproc


@pytest.mark.parametrize("kind", IMAGE_DIRS)
def test_debug_images_match_jax(artifact_runs, kind):
    """Same names, shapes and dtypes; the masks equal; the colour images
    within 1 level on >= 99 % of the values (the flow and phi they show
    agree to 1e-5, and a value on a level boundary may fall either way)."""
    jseq, tseq, _ = artifact_runs
    jfiles = sorted(os.listdir(os.path.join(jseq, kind)))
    tfiles = sorted(os.listdir(os.path.join(tseq, kind)))
    assert tfiles == jfiles == [f"image_{i:05d}.png" for i in range(N_PAIRS)]
    for name in jfiles:
        ref = imread(os.path.join(jseq, kind, name))
        got = imread(os.path.join(tseq, kind, name))
        assert got.shape == ref.shape == (SMALL["height"], SMALL["width"], 3)
        assert got.dtype == ref.dtype == np.uint8
        if kind == "result-images":
            np.testing.assert_array_equal(got, ref)
        else:
            close = np.abs(got.astype(int) - ref.astype(int)) <= 1
            assert close.mean() >= 0.99, (kind, name, close.mean())


def test_video_npz_and_json_match_jax(artifact_runs):
    jseq, tseq, tproc = artifact_runs
    ref = np.load(os.path.join(jseq, "video.npz"))["frames"]
    got = np.load(os.path.join(tseq, "video.npz"))["frames"]
    assert got.shape == ref.shape == (N_PAIRS, SMALL["height"], SMALL["width"], 3)
    assert got.dtype == ref.dtype == np.uint8
    assert (np.abs(got.astype(int) - ref.astype(int)) <= 1).mean() >= 0.99
    assert sorted(os.listdir(os.path.join(tseq, "results"))) == \
        sorted(os.listdir(os.path.join(jseq, "results")))
    # every stage of the loop ran once per batch, the encode once
    assert tproc.tracer.counts["artifacts"] == 3 and tproc.tracer.counts["encode"] == 1


def test_one_pull_per_image_kind_per_batch(tmp_path, monkeypatch):
    """With debug images on, a batch costs one device-to-host copy for the
    scalars and one per image kind (mask, phi, derotated flow), whatever the
    batch size; padded lanes are neither pulled nor written."""
    import torch

    tproc = Processor(_materialised(SyntheticDataset, SyntheticParams, RunConfig,
                                    tmp_path), device="cpu")
    pulls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: pulls.append(tuple(self.shape))
                        or real(self, *a, **k))
    tproc.run_detection_foe()
    assert len(pulls) == 4 * 3
    h, w = SMALL["height"], SMALL["width"]
    assert pulls[-4:] == [(1, h, w), (1, h, w), (1, h, w, 2), (BATCH, 12)]
    for kind in IMAGE_DIRS:
        assert len(os.listdir(tmp_path / "synthetic" / "forward-flight" / kind)) == N_PAIRS


def test_save_images_off_writes_json_only(tmp_path):
    tproc = Processor(_materialised(SyntheticDataset, SyntheticParams, RunConfig,
                                    tmp_path), device="cpu")
    tproc.save_images = False
    tproc.run_detection_foe()
    seq = tproc.dataset.seq_path
    assert len(os.listdir(os.path.join(seq, "results"))) == N_PAIRS
    assert all(not os.listdir(os.path.join(seq, k)) for k in IMAGE_DIRS)
    assert not os.path.exists(os.path.join(seq, "video.npz"))


def test_video_sidecar_cap_and_missing_ffmpeg(tmp_path, monkeypatch, caplog):
    """The npz sidecar is skipped above its byte cap, and without ffmpeg the
    mp4 is skipped with a log line instead of an error."""
    from mav_detection_tpu_torch.data.dataset import imwrite
    from mav_detection_tpu_torch.pipeline import processor as pmod

    proc = port_processor("PRECOMPUTED")
    img_dir = tmp_path / "processed"
    img_dir.mkdir()
    for i in range(3):
        imwrite(str(img_dir / f"image_{i:05d}.png"), np.full((8, 9), 50 * i, np.uint8))
    monkeypatch.setattr(pmod.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING):
        proc._encode_video(str(img_dir), str(tmp_path / "processed.mp4"))
    assert "no ffmpeg" in caplog.text
    frames = np.load(tmp_path / "video.npz")["frames"]
    assert frames.shape == (3, 8, 9, 3) and frames[2, 0, 0].tolist() == [100] * 3
    os.remove(tmp_path / "video.npz")
    monkeypatch.setattr(Processor, "NPZ_MAX_BYTES", 100)
    with caplog.at_level(logging.WARNING):
        proc._encode_video(str(img_dir), str(tmp_path / "processed.mp4"))
    assert "npz encode skipped" in caplog.text
    assert not os.path.exists(tmp_path / "video.npz")


# ------------------------------------------------------- homography branch
HOMOG = dict(height=120, width=160, n_frames=8, expansion=0.035, foe=(95.0, 55.0),
             drone_start=(30.0, 30.0), drone_radius=6)
HOMOG_PAIRS = HOMOG["n_frames"] - 1


def jax_kmeans_inits(n_pairs, batch, n_points, k=8, attempts=10):
    """The JAX processor's k-means draws (processor.py key schedule: one
    split per frame, ``fold_in(key, b0)`` after each batch; kmeans.py: one
    ``choice`` without replacement per attempt)."""
    key = jax.random.PRNGKey(0)
    out = {}
    for b0 in range(0, n_pairs, batch):
        for i in range(b0, min(b0 + batch, n_pairs)):
            key, sub = jax.random.split(key)
            out[i] = np.stack([
                np.asarray(jax.random.choice(s, n_points, (k,), replace=False))
                for s in jax.random.split(sub, attempts)])
        key = jax.random.fold_in(key, b0)
    return out


def _homography_cfg(cfg_cls, ds_cls, params_cls, tmp, **kw):
    cfg = cfg_cls(dataset="synthetic", mode="FLOW_FOE_CLUSTERING",
                  algorithm="HOMOGRAPHY", flow_source="GROUND_TRUTH",
                  headless=True, **kw)
    cfg.get_dataset = lambda **_: ds_cls(params=params_cls(**HOMOG),
                                     materialize_to=str(tmp))
    return cfg


@pytest.fixture(scope="module")
def homography_runs(tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("hj"), tmp_path_factory.mktemp("ht")
    jproc = JProcessor(_homography_cfg(JRunConfig, JSynth, JParams, jdir))
    ref = jproc.run_detection()
    tproc = Processor(_homography_cfg(RunConfig, SyntheticDataset, SyntheticParams,
                                      tdir), device="cpu")
    inits = jax_kmeans_inits(HOMOG_PAIRS, 8, HOMOG["height"] * HOMOG["width"])
    got = tproc.run_detection_homography(kmeans_init=inits)
    return ref, got, jproc.dataset.seq_path, tproc.dataset.seq_path


def test_homography_iou_matches_jax(homography_runs):
    """One FrameResult per pair, whose ``tpr`` is the IoU with the target's
    box: within 0.02 of the JAX processor's with JAX's k-means draws fed
    in, and every other field at its default."""
    ref, got, _, tseq = homography_runs
    assert sorted(got) == sorted(ref) == list(range(HOMOG_PAIRS))
    for i in ref:
        assert got[i].tpr == pytest.approx(ref[i].tpr, abs=0.02), i
        assert got[i].time == pytest.approx(ref[i].time)
        assert got[i].fpr == ref[i].fpr == 0.0
        text = open(os.path.join(tseq, "results", f"image_{i:05d}.json")).read()
        assert text == got[i].to_json()


def test_homography_mosaic_and_box_match_jax(homography_runs):
    """The 2x3 mosaic has the reference's shape, and the box drawn into its
    first tile (pure green, 2 px) sits within 1 px of the reference's."""
    _, got, jseq, tseq = homography_runs
    h, w = HOMOG["height"], HOMOG["width"]

    def green_box(img):
        tile = img[:h, :w]
        ys, xs = np.where((tile == (0, 255, 0)).all(-1))
        return np.array([xs.min(), ys.min(), xs.max(), ys.max()])

    names = sorted(os.listdir(os.path.join(jseq, "processed")))
    assert sorted(os.listdir(os.path.join(tseq, "processed"))) == names
    assert len(names) == HOMOG_PAIRS
    for name in names:
        ref = imread(os.path.join(jseq, "processed", name))
        img = imread(os.path.join(tseq, "processed", name))
        assert img.shape == ref.shape == (2 * h, 3 * w, 3)
        assert np.abs(green_box(img) - green_box(ref)).max() <= 1, name
        # the global-motion and flow tiles show the same fields
        for tile in (np.s_[:h, w:2 * w], np.s_[h:, :w]):
            close = np.abs(img[tile].astype(int) - ref[tile].astype(int)) <= 1
            assert close.mean() >= 0.99


def test_homography_draws_its_own_kmeans_centers(tmp_path):
    """Without fed draws the run is seeded: two runs give the same IoUs."""
    runs = []
    for k in range(2):
        proc = Processor(_homography_cfg(RunConfig, SyntheticDataset,
                                         SyntheticParams, tmp_path / str(k)),
                         device="cpu")
        runs.append({i: fr.tpr for i, fr in proc.run_detection().items()})
    assert runs[0] == runs[1] and sorted(runs[0]) == list(range(HOMOG_PAIRS))
    assert all(0.0 <= v <= 1.0 for v in runs[0].values())


def test_homography_sparse_of(tmp_path, caplog):
    """--use-sparse-of: LK feature tracks replace the sampled-flow
    correspondences and the branch still gives a finite FrameResult per
    pair; the debug log counts the surviving features."""
    cfg = _homography_cfg(RunConfig, SyntheticDataset, SyntheticParams, tmp_path,
                          use_sparse_of=True)
    proc = Processor(cfg, device="cpu")
    with caplog.at_level(logging.DEBUG, logger=proc.logger.name):
        results = proc.run_detection()
    assert sorted(results) == list(range(HOMOG_PAIRS))
    assert all(np.isfinite(fr.tpr) and 0.0 <= fr.tpr <= 1.0 for fr in results.values())
    assert caplog.text.count("features: ") == HOMOG_PAIRS
    assert len(glob.glob(os.path.join(proc.dataset.seq_path, "processed", "*.png"))) \
        == HOMOG_PAIRS


def _two_frames(shift=(3.0, 2.0)):
    import scipy.ndimage as ndi

    rng = np.random.default_rng(3)
    tex = ndi.gaussian_filter(rng.uniform(0, 255, (96, 128)).astype(np.float32), 2.0) * 4
    f0 = np.repeat(tex[..., None], 3, -1).astype(np.uint8)
    f1 = np.repeat(np.roll(tex, (int(shift[1]), int(shift[0])), (0, 1))[..., None],
                   3, -1).astype(np.uint8)
    grid = rng.uniform(20, 70, (200, 2)).astype(np.float32)
    return f0, f1, grid, grid + np.float32(shift)


class _TwoFrames:
    def __init__(self, f0, f1):
        self.frames = [f0, f1]

    def get_frame(self, i):
        return self.frames[i]


def _bare_processor(proc_cls, cfg_cls, ds, **extra):
    cfg = cfg_cls(dataset="synthetic", use_sparse_of=True, algorithm="HOMOGRAPHY",
                  headless=True)
    proc = proc_cls.__new__(proc_cls)
    proc.config, proc.logger, proc.dataset = cfg, cfg.logger, ds
    for k, v in extra.items():
        setattr(proc, k, v)
    return proc


def test_sparse_correspondences_match_jax():
    """The same corners tracked to the same places (1e-2 px), the same
    slots replaced; and the homography fitted to them recovers the shift."""
    import torch

    from mav_detection_tpu_torch.ops.geometry import (
        fit_homography_lstsq,
        homography_motion_field,
    )

    f0, f1, grid, moved = _two_frames()
    ds = _TwoFrames(f0, f1)
    jp0, jp1 = _bare_processor(JProcessor, JRunConfig, ds)._sparse_correspondences(
        ds, 0, grid, moved)
    tproc = _bare_processor(Processor, RunConfig, ds, device=torch.device("cpu"))
    p0, p1 = tproc._sparse_correspondences(0, torch.from_numpy(grid),
                                           torch.from_numpy(moved))
    replaced = ~np.isclose(jp0, grid).all(1)
    assert replaced.sum() > 50
    np.testing.assert_array_equal(p0.numpy(), jp0)
    # a corner whose window is clamped at the frame's edge is ill-conditioned
    # on both sides (see test_torch_lucas_kanade.py): hold the others
    inner = ((jp0 >= 10) & (jp0 <= np.array([128, 96]) - 11)).all(1)
    np.testing.assert_allclose(p1.numpy()[inner], jp1[inner], atol=1e-2)
    gm = homography_motion_field(fit_homography_lstsq(p0, p1), 96, 128).numpy()
    np.testing.assert_allclose(gm[20:-20, 20:-20].mean((0, 1)), [3.0, 2.0], atol=0.3)


def test_sparse_correspondences_fall_back_without_tracks():
    """No corner on a flat frame: every slot keeps the sampled
    correspondence, upstream's fallback."""
    import torch

    flat = np.full((96, 128, 3), 90, np.uint8)
    _, _, grid, moved = _two_frames()
    tproc = _bare_processor(Processor, RunConfig, _TwoFrames(flat, flat),
                            device=torch.device("cpu"))
    p0, p1 = tproc._sparse_correspondences(0, torch.from_numpy(grid),
                                           torch.from_numpy(moved))
    np.testing.assert_array_equal(p0.numpy(), grid)
    np.testing.assert_array_equal(p1.numpy(), moved)


# --------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv,n_mosaics", [
    (["--algorithm", "HOMOGRAPHY", "--flow-source", "GROUND_TRUTH"], 1),
    (["--algorithm", "HOMOGRAPHY", "--flow-source", "GROUND_TRUTH",
      "--use-sparse-of", "--debug"], 1),
    (["--flow-source", "GROUND_TRUTH", "--algorithm", "FOE"], 0)])
def test_cli_accepts_the_new_flags(argv, n_mosaics, tmp_path, monkeypatch):
    """The newly ported flags run end to end on a short sequence (the
    dataset factory is swapped for a 4-frame one)."""
    monkeypatch.chdir(tmp_path)
    from mav_detection_tpu_torch.core import config as cfgmod

    monkeypatch.setattr(
        cfgmod.RunConfig, "get_dataset",
        lambda self, **_: SyntheticDataset(params=SyntheticParams(
            **dict(HOMOG, n_frames=4)), materialize_to=str(tmp_path)))
    cli_main(["--dataset", "synthetic", "--device", "cpu", "--headless", *argv])
    seq = tmp_path / "synthetic" / "forward-flight"
    assert len(list((seq / "results").glob("image_*.json"))) == 3
    pngs = list((seq / "processed").glob("image_*.png"))
    assert len(pngs) == 3
    assert (imread(str(pngs[0])).shape == (240, 480, 3)) == bool(n_mosaics)
    logging.getLogger("main").setLevel(logging.INFO)
    logging.getLogger("mav_detection_tpu_torch").setLevel(logging.NOTSET)


def test_cli_rejects_unknown_algorithm():
    with pytest.raises(ValueError, match="Algorithm"):
        cli_main(["--dataset", "synthetic", "--device", "cpu",
                  "--algorithm", "MAGIC"])


# ------------------------------------------------------- RAFT flow source
# The reference's RAFT needs a 1/64-scale pyramid level, so at least 64 px a
# side: 64x96, 4 frames, batch 2 (a full contiguous batch and a padded tail).
# A drone of ~200 px, so that one pixel flipped by bf16 rounding moves a
# rate by 0.005, not 0.012.
RAFT_SEQ = dict(SMALL, height=64, width=96, n_frames=4, foe=(40.0, 30.0),
                drone_start=(20.0, 44.0), drone_radius=8)


@pytest.fixture
def j_raft_cached(monkeypatch):
    """The JAX loader's cache holding the shipped RAFT tree (its own load
    builds a template with ``model.init`` first, over a minute on a CPU)."""
    from flax import serialization

    from mav_detection_tpu.models import pretrained as j_pretrained
    from mav_detection_tpu.models.raft import RAFTConfig as JRAFTConfig

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints", "raft.msgpack")
    with open(path, "rb") as f:
        tree = j_pretrained._migrate_raft_state(serialization.msgpack_restore(f.read()))
    monkeypatch.setitem(j_pretrained._CACHE, ("raft", JRAFTConfig()), tree)


def test_raft_json_fields_match(j_raft_cached, monkeypatch):
    """Both run the shipped RAFT through the video path: a contiguous batch
    and a padded tail. FoE within 0.5 px, rates within 0.02, as for
    Farneback; everything else within 1e-3. Both in the fp32 config: in
    the product bf16 one the two frameworks' flows differ by up to ~0.05 px
    (held in test_torch_raft.py), which on a 64x96 frame moves the dynamic
    threshold by whole rows of pixels (fpr 0.055 apart, measured)."""
    import jax.numpy as jnp

    import mav_detection_tpu.models.raft as jr
    import mav_detection_tpu_torch.models.raft as tr

    monkeypatch.setattr(jr, "tuned_raft_config", lambda h, w: jr.TunedRAFT(
        config=jr.RAFTConfig(materialize_corr=False, dtype=jnp.float32)))
    monkeypatch.setattr(tr, "tuned_raft_config", lambda h, w: tr.TunedRAFT(
        config=tr.RAFTConfig(materialize_corr=False, dtype=torch.float32)))
    ref = run_jax("RAFT", seq=RAFT_SEQ)
    got = run_port("RAFT", seq=RAFT_SEQ)
    assert sorted(got) == sorted(ref) == list(range(RAFT_SEQ["n_frames"] - 1))
    for i in ref:
        r, g = _vals(ref[i]), _vals(got[i])
        for k in r:
            tol = {"foe_dense": 0.5, "tpr": 0.02, "fpr": 0.02, "tpr_fixed": 0.02,
                   "fpr_fixed": 0.02}.get(k, 1e-3)
            np.testing.assert_allclose(g[k], r[k], atol=tol, equal_nan=True,
                                       err_msg=f"frame {i} {k}")


def test_raft_stages_frames_as_they_come_and_counts_real_lanes(monkeypatch):
    """RAFT stages the B+1 BGR frames of a contiguous batch (not gray), and
    the padded tail's escalation sees its real lanes only."""
    import mav_detection_tpu_torch.pipeline.processor as pmod

    proc = port_processor("RAFT", RAFT_SEQ)
    staged = proc._stage_batch([0, 1], FlowSource.RAFT)
    np.testing.assert_array_equal(
        staged["frames"], np.stack([proc.dataset.get_frame(i) for i in range(3)]))
    seen = []
    real = pmod.raft_flow_video_tuned

    def spy(frames, **kw):
        seen.append((tuple(frames.shape), kw["n_real"]))
        return real(frames, **kw)

    monkeypatch.setattr(pmod, "raft_flow_video_tuned", spy)
    proc.save_images = False
    proc.run_detection_foe()
    h, w = RAFT_SEQ["height"], RAFT_SEQ["width"]
    assert seen == [((3, h, w, 3), 2), ((3, h, w, 3), 1)]


def test_raft_pair_and_unstaged_paths_agree_with_the_video_path():
    """Non-contiguous staging (prevs/currs through raft_flow_batch_tuned) and
    the unstaged ``_flow_batch`` of the homography branch give the video
    path's flow (bf16 convolutions batched differently: within 0.1 px)."""
    proc = port_processor("RAFT", RAFT_SEQ)
    video = proc._flow_from_staged(proc._stage_batch([0, 1], FlowSource.RAFT),
                                   FlowSource.RAFT)
    pairs = proc._flow_from_staged(proc._stage_batch([1, 0], FlowSource.RAFT),
                                   FlowSource.RAFT)
    unstaged = proc._flow_batch([0, 1])
    assert video.shape == (2, RAFT_SEQ["height"], RAFT_SEQ["width"], 2)
    np.testing.assert_allclose(pairs.numpy()[::-1], video.numpy(), atol=0.1)
    np.testing.assert_allclose(unstaged.numpy(), video.numpy(), atol=0.1)


def test_raft_homography_branch_runs(tmp_path):
    proc = port_processor("RAFT", RAFT_SEQ, algorithm="HOMOGRAPHY")
    proc.dataset.seq_path = ""
    res = proc.run_detection()
    assert sorted(res) == list(range(RAFT_SEQ["n_frames"] - 1))


def test_cli_accepts_raft_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    import mav_detection_tpu_torch.data as data_mod

    monkeypatch.setenv("SYNTHETIC_PATH", str(tmp_path))
    monkeypatch.setattr(data_mod, "make_dataset", lambda *a, **k: SyntheticDataset(
        params=SyntheticParams(**RAFT_SEQ)))
    cli_main(["--dataset", "synthetic", "--flow-source", "RAFT", "--headless",
              "--device", "cpu", "--batch-size", "2", "--foe-samples", "200"])
    results = sorted(tmp_path.rglob("results/image_*.json"))
    assert len(results) == RAFT_SEQ["n_frames"] - 1


# ----------------------------------------- conversions and the CLI's execute
@pytest.mark.parametrize("mode", ["FLOW_RADIAL", "FLOW_FOE_YOLO", "APPEARANCE_RGB"])
def test_convert_uses_per_sequence_flow_and_mode_imagery(mode, tmp_path, monkeypatch):
    """--prepare-dataset (tests/test_pipeline.py's convert case, on the
    port): the images go through the shared mode transform, and the flow
    comes from the sequence being exported (the dataset is re-created per
    sequence through ``make_dataset``, which regenerates the same content);
    APPEARANCE_RGB copies the frames."""
    from mav_detection_tpu_torch.core.config import Mode
    from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host

    ds = SyntheticDataset(materialize_to=str(tmp_path))
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    monkeypatch.setenv("YOLOv4_PATH", str(tmp_path / "yolo"))
    monkeypatch.setenv("SYNTHETIC_PATH", str(tmp_path))
    os.makedirs(tmp_path / "yolo" / "dataset" / "images")
    (tmp_path / "yolo" / "dataset" / "images" / "stale.png").write_bytes(b"x")

    cfg = RunConfig(dataset="synthetic", mode=mode, flow_source="GROUND_TRUTH",
                    headless=True)
    cfg.settings = {"train_sequences": [ds.sequence]}
    proc = Processor(cfg, device="cpu")
    proc.convert(Mode[mode])

    imgs = sorted(glob.glob(f"{tmp_path}/yolo/dataset/images/*.png"))
    anns = sorted(glob.glob(f"{tmp_path}/yolo/dataset/labels/yolo/*.txt"))
    n = ds.N if mode == "APPEARANCE_RGB" else ds.N - 2   # last pair has no flow
    assert len(imgs) == len(anns) == n
    assert os.path.basename(imgs[0]) == "000000.png"
    expected = mode_image_host(np.asarray(ds.get_frame(0)),
                               np.asarray(ds.get_gt_of(0), np.float32), mode,
                               seed=0, device="cpu")
    np.testing.assert_array_equal(imread(imgs[0]), np.asarray(expected, np.uint8))
    with open(anns[3]) as f, open(f"{ds.seq_path}/annotation/image_00003.txt") as g:
        assert f.read() == g.read()
    assert proc.dataset is not None and proc.dataset.N == ds.N


def test_convert_refuses_unequal_inputs(tmp_path, monkeypatch):
    from mav_detection_tpu_torch.core.config import Mode

    ds = SyntheticDataset(params=SyntheticParams(**SMALL), materialize_to=str(tmp_path))
    os.remove(f"{ds.seq_path}/annotation/image_00002.txt")
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    monkeypatch.setenv("YOLOv4_PATH", str(tmp_path / "yolo"))
    cfg = RunConfig(dataset="synthetic", mode="FLOW_UV", flow_source="GROUND_TRUTH")
    cfg.settings = {"train_sequences": [ds.sequence]}
    cfg.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(**SMALL))
    with pytest.raises(ValueError, match="input sizes do not match"):
        Processor(cfg, device="cpu").convert(Mode.FLOW_UV)


def _midgard_with_csv(root):
    """A 4-frame MIDGARD-layout sequence with MIDGARD csv annotations: one
    box, a row with a NaN, an empty file, two boxes."""
    _dataset_layout("midgard", root)
    seq = "countryside-natural/north-narrow"
    ann = root / seq / "annotation"
    os.makedirs(ann)
    rows = ["0,10.5,12.25,8,6\n", "1,nan,3,4,5\n2,30,20,11.5,9\n", "",
            "3,1,2,3,4\n3,40.75,22,6,6.5\n"]
    for i, text in enumerate(rows):
        (ann / f"annot_{i:05d}.csv").write_text(text)
    (ann / "image_00009.txt").write_text("stale")
    return seq, ann


def test_annotations_to_yolo_matches_jax(tmp_path, monkeypatch):
    """--data-to-yolo: the MIDGARD csv files become the YOLO .txt files the
    JAX Processor writes, byte for byte; stale .txt files go first."""
    from mav_detection_tpu.pipeline.processor import Processor as JProc

    out = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag
        seq, ann = _midgard_with_csv(root)
        monkeypatch.setenv("MIDGARD_PATH", str(root))
        if tag == "jax":
            cfg = JRunConfig(dataset="midgard", flow_source="GROUND_TRUTH")
            cfg.settings = {"train_sequences": [seq], "validation_sequences": []}
            JProc(cfg).annotations_to_yolo()
        else:
            cfg = RunConfig(dataset="midgard", flow_source="GROUND_TRUTH")
            cfg.settings = {"train_sequences": [seq], "validation_sequences": []}
            Processor(cfg, device="cpu").annotations_to_yolo()
        out[tag] = {p.name: p.read_text() for p in sorted(ann.glob("*.txt"))}
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == [f"image_{i:05d}.txt" for i in range(4)]
    assert out["port"]["image_00002.txt"] == ""
    assert len(out["port"]["image_00003.txt"].splitlines()) == 2


def test_undistort_passthrough(tmp_path, monkeypatch, caplog):
    """--undistort: without UNDISTORT_PATH a warning and nothing else; with
    it the tool runs once per frame (``--run <calibration> <in> <out>``)
    into undistorted/, skipping frames already done."""
    seq, _ = _midgard_with_csv(tmp_path)
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    cfg = RunConfig(dataset="midgard", flow_source="GROUND_TRUTH")
    cfg.settings = {"train_sequences": [], "validation_sequences": [seq]}
    proc = Processor(cfg, device="cpu")
    monkeypatch.delenv("UNDISTORT_PATH", raising=False)
    with caplog.at_level(logging.WARNING):
        proc.undistort()
    assert "UNDISTORT_PATH not set" in caplog.text
    assert not (tmp_path / seq / "undistorted").exists()

    cal = tmp_path / seq / "info" / "calibration"
    os.makedirs(cal)
    (cal / "cam.txt").write_text("k")
    tool = tmp_path / "undistort.sh"
    log = tmp_path / "calls.txt"
    tool.write_text(f'#!/bin/sh\necho "$1 $2" >> {log}\ncp "$3" "$4"\n')
    tool.chmod(0o755)
    monkeypatch.setenv("UNDISTORT_PATH", str(tool))
    (tmp_path / seq / "undistorted").mkdir()
    (tmp_path / seq / "undistorted" / "image_00001.png").write_bytes(b"done")
    proc.undistort()
    out = sorted(p.name for p in (tmp_path / seq / "undistorted").iterdir())
    assert out == [f"image_{i:05d}.png" for i in range(4)]
    calls = log.read_text().splitlines()
    assert calls == [f"--run {cal / 'cam.txt'}"] * 3


class _Recorder:
    """Stand-ins for the CLI's Processor and Validator that record calls."""

    def __init__(self):
        self.calls = []
        rec = self

        class P:
            def __init__(self, config, device="cuda"):
                rec.calls.append(("Processor", config.mode.name, str(device)))

            def run_detection(self):
                rec.calls.append("run_detection")
                return {}

            def convert(self, mode):
                rec.calls.append(("convert", mode.name))

            def annotations_to_yolo(self):
                rec.calls.append("annotations_to_yolo")

            def undistort(self):
                rec.calls.append("undistort")

            def release(self):
                rec.calls.append("release")

        class V:
            def __init__(self, config, device="cuda"):
                self.config = config

            def run_validation(self):
                rec.calls.append(("validate", self.config.mode.name))
                return {}

        self.P, self.V = P, V


@pytest.mark.parametrize("argv,calls", [
    ([], [("Processor", "FLOW_UV", "cpu"), "run_detection", ("validate", "FLOW_UV"),
          "release"]),
    (["--validate"], [("validate", "FLOW_UV")]),
    (["--validate", "--mode", "FLOW_FOE_YOLO"], [("validate", "FLOW_FOE_YOLO")]),
    (["--validate", "--mode", "FLOW_FOE_CLUSTERING"],
     [("Processor", "FLOW_FOE_CLUSTERING", "cpu"), "run_detection",
      ("validate", "FLOW_FOE_CLUSTERING"), "release"]),
    (["--prepare-dataset", "--mode", "FLOW_FOE_YOLO"],
     [("Processor", "FLOW_FOE_YOLO", "cpu"), ("convert", "FLOW_FOE_YOLO"), "release"]),
    (["--data-to-yolo"], [("Processor", "FLOW_UV", "cpu"), "annotations_to_yolo", "release"]),
    (["--undistort"], [("Processor", "FLOW_UV", "cpu"), "undistort", "release"])],
    ids=["defaults", "validate-nn", "validate-foe-yolo", "validate-clustering",
         "prepare-dataset", "data-to-yolo", "undistort"])
def test_cli_execute_branches(argv, calls, monkeypatch):
    """``execute`` takes the reference's branches: detection then
    validation; validation alone with --validate in an NN mode; a
    conversion instead of detection."""
    from mav_detection_tpu_torch.cli import main as cli

    rec = _Recorder()
    monkeypatch.setattr(cli, "Processor", rec.P)
    monkeypatch.setattr(cli, "Validator", rec.V)
    cli_main(["--device", "cpu", "--headless", *argv])
    assert rec.calls == calls


@pytest.mark.parametrize("argv,env,mine", [
    (["--num-hosts", "2", "--host-index", "1"], {}, ["b", "d"]),
    ([], {"MAV_NUM_HOSTS": "3", "MAV_HOST_INDEX": "0"}, ["a", "d"]),
    ([], {}, ["a", "b", "c", "d", "e"])], ids=["flags", "env", "one-host"])
def test_cli_run_all_shards_the_validation_sequences(argv, env, mine, tmp_path, monkeypatch):
    """--run-all validates each of this host's validation sequences with the
    reference's configuration (FLOW_FOE_CLUSTERING, debug, validate)."""
    from mav_detection_tpu_torch.cli import main as cli

    monkeypatch.chdir(tmp_path)
    (tmp_path / "settings.json").write_text(json.dumps(
        {"validation_sequences": ["a", "b", "c", "d", "e"]}))
    for k in ("MAV_NUM_HOSTS", "MAV_HOST_INDEX"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(cli, "execute", lambda config, device: seen.append((config, device)))
    cli_main(["--run-all", "--device", "cpu", "--flow-source", "GROUND_TRUTH", *argv])
    assert [c.sequence for c, _ in seen] == mine
    for config, device in seen:
        assert device == "cpu" and config.validate and config.debug
        assert config.mode.name == "FLOW_FOE_CLUSTERING"
        assert config.dataset == "midgard" and config.flow_source == FlowSource.GROUND_TRUTH


def test_cli_writes_the_reference_validation_outputs(tmp_path, monkeypatch):
    """--device cpu on a short synthetic sequence, mode FLOW_UV, GT flow:
    the port's CLI writes what the reference's ``execute`` writes (the
    FrameResult JSON, validation.npy, the box cache under the same name,
    ious.png and the figures) and returns NN IoU stats within 0.05 of the JAX
    ones; the FoE
    statistics are computed on both sides."""
    from mav_detection_tpu.cli import main as jcli
    from mav_detection_tpu.eval.validator import Validator as JV

    from mav_detection_tpu_torch.cli import main as cli
    from mav_detection_tpu_torch.core import config as cfgmod

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("YOLO_INFERENCE_HOST", raising=False)
    seq = dict(SMALL, height=64, width=96, n_frames=5, drone_radius=8,
               drone_start=(20.0, 30.0))
    stats = {}

    def capture(tag, real):
        def run(self):
            stats[tag] = real(self)
            return stats[tag]
        return run

    monkeypatch.setattr(JV, "run_validation", capture("jax", JV.run_validation))
    monkeypatch.setattr(cli.Validator, "run_validation",
                        capture("port", cli.Validator.run_validation))
    jcfg = JRunConfig(dataset="synthetic", mode="FLOW_UV", flow_source="GROUND_TRUTH",
                      headless=True, batch_size=2)
    jcfg.get_dataset = lambda **_: JSynth(params=JParams(**seq),
                                          materialize_to=str(tmp_path / "jax"))
    jcli.execute(jcfg)
    monkeypatch.setattr(cfgmod.RunConfig, "get_dataset", lambda self, **_: SyntheticDataset(
        params=SyntheticParams(**seq), materialize_to=str(tmp_path / "port")))
    cli_main(["--dataset", "synthetic", "--flow-source", "GROUND_TRUTH", "--headless",
              "--device", "cpu", "--batch-size", "2"])
    files = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag / "synthetic" / "forward-flight"
        files[tag] = (sorted(p.name for p in root.iterdir() if p.is_file()),
                      sorted(p.name for p in (root / "bounding-boxes").iterdir()),
                      len(list((root / "results").glob("image_*.json"))))
    assert files["port"][1:] == files["jax"][1:]
    # processed.mp4 is the reference's cv2.VideoWriter fallback, which the
    # port does not have
    assert set(files["jax"][0]) - {"processed.mp4"} <= set(files["port"][0])
    assert {"validation.npy", "ious.png"} <= set(files["port"][0])
    assert abs(stats["port"]["iou_mean"] - stats["jax"]["iou_mean"]) <= 0.05
    assert stats["port"]["detection_rate"] == stats["jax"]["detection_rate"]
    assert set(stats["port"]) == set(stats["jax"])
    assert stats["port"]["foe_mean"] is not None
    logging.getLogger("main").setLevel(logging.INFO)
    logging.getLogger("mav_detection_tpu_torch").setLevel(logging.NOTSET)

"""The port's copied host modules match their JAX-package originals:
FrameResult JSON bytes, Rectangle, the .flo codec, config enums, datasets."""
import dataclasses
import json

import numpy as np
import pytest

from mav_detection_tpu.core import config as jconfig
from mav_detection_tpu.core import flo as jflo
from mav_detection_tpu.core.frame_result import FrameResult as JFrameResult
from mav_detection_tpu.core.rectangle import Rectangle as JRect
from mav_detection_tpu.core.rectangle import parse_yolo_annotation as jparse
from mav_detection_tpu.data import dataset as jdataset
from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
from mav_detection_tpu.ops.image.color import bgr_to_gray_host as jgray

from mav_detection_tpu_torch.core import config as tconfig
from mav_detection_tpu_torch.core import flo as tflo
from mav_detection_tpu_torch.core.frame_result import FrameResult as TFrameResult
from mav_detection_tpu_torch.core.rectangle import Rectangle as TRect
from mav_detection_tpu_torch.core.rectangle import parse_yolo_annotation as tparse
from mav_detection_tpu_torch.data import dataset as tdataset
from mav_detection_tpu_torch.data import make_dataset
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset as TSynth
from mav_detection_tpu_torch.data.synthetic import SyntheticParams as TParams
from mav_detection_tpu_torch.ops.image.color import bgr_to_gray_host as tgray


@pytest.fixture
def rng():
    """A generator of this test's own. The repository-wide ``rng`` fixture is
    one stream for the whole test run: drawing from it here would shift the
    numbers that the JAX package's tests draw after this file in the same
    worker process."""
    return np.random.default_rng(1234)

FR_KW = dict(time=0.35, tpr=0.912345678, fpr=float("nan"), tpr_fixed=1.0,
             fpr_fixed=0.0015, sky_tpr=0.94, sky_fpr=0.0,
             drone_size_pixels=254.0, drone_flow_pixels=(4.25, -1.5),
             foe_dense=(190.12345, 110.5), foe_gt=(190.0, 110.0),
             center_phi=-149.83691)


class TestFrameResult:
    def test_json_bytes_identical(self):
        assert TFrameResult(**FR_KW).to_json() == JFrameResult(**FR_KW).to_json()

    def test_numpy_scalars_and_roundtrip(self, tmp_path):
        kw = dict(FR_KW, tpr=np.float32(0.5), drone_size_pixels=np.int64(7))
        t = TFrameResult(**kw)
        assert t.to_json() == JFrameResult(**kw).to_json()
        path = tmp_path / "image_00000.json"
        path.write_text(t.to_json())
        back = JFrameResult.from_json_file(str(path))
        assert json.dumps(back.to_dict()) == json.dumps(
            TFrameResult.from_json_file(str(path)).to_dict())


class TestRectangle:
    @pytest.mark.parametrize("a,b", [
        (((0, 0), (10, 10)), ((5, 0), (10, 10))),
        (((0, 0), (10, 10)), ((12, 12), (10, 10))),
        (((0, 0), (10, 10)), ((50, 50), (10, 10))),
        (((3.5, 2.0), (0.5, 0.5)), ((3.0, 2.0), (4.0, 4.0))),
    ])
    def test_iou_and_accessors_match(self, a, b):
        for fn in ("calculate_iou", "calculate_iou_safe"):
            assert (getattr(TRect, fn)(TRect(*a), TRect(*b))
                    == getattr(JRect, fn)(JRect(*a), JRect(*b)))
        for m in ("get_center", "get_bottomright_int", "get_area",
                  "get_center_int", "get_topleft_int"):
            assert getattr(TRect(*a), m)() == getattr(JRect(*a), m)()

    def test_yolo_lines_and_parse(self, tmp_path):
        img = np.array([752, 480])
        t = TRect.from_center((100.0, 200.0), (50.0, 30.0))
        j = JRect.from_center((100.0, 200.0), (50.0, 30.0))
        assert t.to_yolo(img) == j.to_yolo(img)
        path = tmp_path / "a.txt"
        path.write_text(t.to_yolo(img) + "0 0.5 0.5 0.0001 0.0001\n\n")
        tp = tparse(str(path), img)
        jp = jparse(str(path), img)
        assert [(r.topleft, r.size) for r in tp] == [(r.topleft, r.size) for r in jp]
        assert len(tp) == 1


class TestFlo:
    def test_cross_package_roundtrip(self, tmp_path, rng):
        uv = rng.standard_normal((17, 23, 2)).astype(np.float32)
        tflo.write_flow(str(tmp_path / "t.flo"), uv)
        jflo.write_flow(str(tmp_path / "j.flo"), uv)
        assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
        np.testing.assert_array_equal(tflo.read_flow(str(tmp_path / "j.flo")), uv)
        batch = tflo.read_flow_batch([str(tmp_path / "t.flo")] * 3)
        assert batch.shape == (3, 17, 23, 2)
        np.testing.assert_array_equal(batch[2], uv)

    def test_bad_magic_raises(self, tmp_path):
        p = tmp_path / "bad.flo"
        p.write_bytes(np.array([1.0, 2.0], np.float32).tobytes())
        with pytest.raises(ValueError, match="Invalid .flo"):
            tflo.read_flow(str(p))


class TestConfig:
    @pytest.mark.parametrize("name", ["Mode", "DatasetType", "Algorithm", "FlowSource"])
    def test_enums_identical(self, name):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]

    def test_run_config_parses_like_reference(self):
        kw = dict(dataset="synthetic", mode="flow_foe_clustering",
                  algorithm="foe", flow_source="farneback", batch_size=4)
        t, j = tconfig.RunConfig(**kw), jconfig.RunConfig(**kw)
        for f in ("mode", "algorithm", "flow_source"):
            assert getattr(t, f).name == getattr(j, f).name
        assert t.get_dataset_type().name == j.get_dataset_type().name
        assert t.uses_nn_for_detection() == j.uses_nn_for_detection()
        assert t.settings == j.settings
        with pytest.raises(ValueError):
            tconfig.RunConfig(mode="NOPE")
        with pytest.raises(ValueError):
            tconfig.RunConfig(engine="warp")


SMALL = dict(height=48, width=64, n_frames=5, expansion=0.08, foe=(30.0, 20.0),
             drone_radius=5, drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))


class TestSyntheticDataset:
    @pytest.mark.parametrize("kw", [SMALL, dict(SMALL, seed=3, omega_amp=0.01,
                                                  horizon=0.5, height=37)])
    def test_arrays_bit_equal(self, kw):
        t, j = TSynth(params=TParams(**kw)), JSynth(params=JParams(**kw))
        for a in ("frames", "flows", "segs", "sky_est", "depth", "omegas",
                  "foes", "drone_pos", "sky_gt"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a), err_msg=a)
        for i in range(t.N - 1):
            np.testing.assert_array_equal(t.get_segmentation(i), j.get_segmentation(i))
            np.testing.assert_array_equal(t.get_angular_difference(i, i + 1),
                                          j.get_angular_difference(i, i + 1))
            assert t.get_gt_foe(i) == j.get_gt_foe(i)
            assert t.get_time(i) == j.get_time(i)
            assert t.get_delta_time(i) == j.get_delta_time(i)
            assert ([(r.topleft, r.size) for r in t.get_annotation(i)]
                    == [(r.topleft, r.size) for r in j.get_annotation(i)])
        assert dataclasses.asdict(TParams(**kw)) == dataclasses.asdict(JParams(**kw))

    def test_make_dataset(self, tmp_path, monkeypatch):
        """The synthetic fixture and a MIDGARD sequence construct; a value
        that is no DatasetType raises the reference's ValueError."""
        ds = make_dataset(tconfig.DatasetType.SYNTHETIC)
        assert ds.N == TParams().n_frames
        TSynth(sequence="countryside-natural/north-narrow",
               params=TParams(**SMALL), materialize_to=str(tmp_path))
        monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
        mg = make_dataset(tconfig.DatasetType.MIDGARD, device="cpu")
        assert type(mg).__name__ == "MidgardDataset" and mg.N == SMALL["n_frames"]
        with pytest.raises(ValueError, match="Invalid dataset type"):
            make_dataset(99)

    def test_materialize_layout(self, tmp_path):
        pytest.importorskip("imageio")
        t = TSynth(params=TParams(**SMALL), materialize_to=str(tmp_path))
        seq = tmp_path / t.sequence
        assert len(list((seq / "images").glob("image_*.png"))) == t.N
        np.testing.assert_array_equal(
            jflo.read_flow(str(seq / "optical-flow" / "image_00001.flo")), t.flows[1])
        np.testing.assert_array_equal(
            jdataset.read_pfm(str(seq / "depths" / "image_00000.pfm")), t.depth)
        np.testing.assert_array_equal(tdataset.imread(str(seq / "images" / "image_00002.png")),
                                      t.frames[2])
        # the flow colour images, as the reference writes them
        vis = sorted((seq / "optical-flow-vis").glob("image_*.png"))
        assert len(vis) == t.N - 1
        j = JSynth(params=JParams(**SMALL), materialize_to=str(tmp_path / "jax"))
        for p in vis:
            np.testing.assert_array_equal(
                tdataset.imread(str(p)),
                jdataset.imread(str(tmp_path / "jax" / j.sequence / "optical-flow-vis" / p.name)))
        assert t.results_path == str(seq / "results")


def test_pfm_cross_package(tmp_path, rng):
    img = rng.random((9, 13)).astype(np.float32)
    tdataset.write_pfm(str(tmp_path / "a.pfm"), img)
    np.testing.assert_array_equal(jdataset.read_pfm(str(tmp_path / "a.pfm")), img)
    jdataset.write_pfm(str(tmp_path / "b.pfm"), img)
    np.testing.assert_array_equal(tdataset.read_pfm(str(tmp_path / "b.pfm")), img)


def test_resize_nearest_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 255, (31, 45, 3)).astype(np.uint8)
    for w, h in ((45, 31), (90, 62), (20, 13), (64, 48)):
        np.testing.assert_array_equal(
            tdataset._resize_nearest(img, w, h),
            cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_gray_host_identical(rng, dtype):
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tgray(img, dtype), jgray(img, dtype))

"""The port's native ``.flo`` loader (``runtime/native_loader.py`` over
``runtime/native/loader.cpp``, built with g++ at first use): the cases of
tests/test_native_runtime.py against the port's bindings, the source held
byte-equal to the reference's, the native reader bit-equal to the port's
numpy reader, the build module, and the prefetcher inside the Processor's
PRECOMPUTED and GROUND_TRUTH runs."""
import logging
import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from mav_detection_tpu_torch import _build
from mav_detection_tpu_torch.core import flo as tflo
from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.pipeline.processor import Processor
from mav_detection_tpu_torch.runtime import native_loader as native

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(height=48, width=64, n_frames=6, expansion=0.08, foe=(30.0, 20.0),
             drone_radius=5, drone_start=(10.0, 30.0), drone_velocity=(2.0, 1.0))


@pytest.fixture(scope="module")
def flo_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("flo")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        p = str(d / f"{i:06d}.flo")
        tflo.write_flow(p, rng.normal(size=(40, 60, 2)).astype(np.float32))
        paths.append(p)
    return paths


def test_loader_source_is_the_references():
    ours = REPO / "mav_detection_tpu_torch" / "runtime" / "native" / "loader.cpp"
    theirs = REPO / "mav_detection_tpu" / "runtime" / "native" / "loader.cpp"
    assert ours.read_bytes() == theirs.read_bytes()


class TestBuild:
    def test_library_lies_under_build_keyed_by_hash(self):
        path = _build.build(["loader"])["loader"]
        assert path.exists() and path.parent == REPO / "build" / "native"
        assert path == _build._target(_build.SOURCES["loader"])
        assert path.name.startswith("libloader-") and len(path.stem) == len("libloader-") + 12
        # nothing is written beside the source
        assert not list((REPO / "mav_detection_tpu_torch" / "runtime").rglob("*.so"))

    def test_hash_follows_source_and_flags(self, tmp_path):
        src = _build.SOURCES["loader"]
        other = tmp_path / "loader.cpp"
        other.write_bytes(src.path.read_bytes() + b"\n// edited\n")
        assert _build._target(src._replace(path=other)).name != _build._target(src).name
        assert _build._target(src._replace(flags=src.flags + ("-g",))).name != \
            _build._target(src).name

    def test_missing_compiler_raises_and_numpy_reads(self, monkeypatch, caplog, flo_dir):
        """No g++: the build raises, ``available`` says so once at INFO, and
        ``read_flow_batch`` reads with numpy."""
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            _build._gxx()
        monkeypatch.setattr(_build, "_LIBS", {})
        monkeypatch.setattr(_build, "_target", lambda src: Path("/nonexistent/lib.so"))
        monkeypatch.setattr(native, "_AVAILABLE", None)
        with caplog.at_level(logging.INFO, logger="mav_detection_tpu_torch.runtime"):
            assert native.available() is False
            assert native.available() is False
            batch = tflo.read_flow_batch(flo_dir[:3])
        assert caplog.text.count("read with numpy") == 1
        np.testing.assert_array_equal(batch[2], tflo.read_flow(flo_dir[2]))
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.read_flow(flo_dir[0])

    def test_a_failed_build_raises_with_the_compilers_output(self, monkeypatch, tmp_path):
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        src = _build.SOURCES["loader"]._replace(path=bad, out_dir=tmp_path / "out")
        monkeypatch.setitem(_build.SOURCES, "bad", src)
        with pytest.raises(RuntimeError, match="build failed for bad.cpp"):
            _build.build(["bad"])
        assert not list((tmp_path / "out").glob("*"))

    def test_sources_build_side_by_side(self, monkeypatch, tmp_path):
        """Two sources not built yet: both compilers are started before
        either is waited for."""
        events = []
        real_popen = _build.subprocess.Popen

        class Watched(real_popen):
            def __init__(self, *a, **k):
                events.append("start")
                super().__init__(*a, **k)

            def communicate(self, *a, **k):
                events.append("wait")
                return super().communicate(*a, **k)

        monkeypatch.setattr(_build.subprocess, "Popen", Watched)
        base = _build.SOURCES["loader"]
        for name in ("one", "two"):
            monkeypatch.setitem(_build.SOURCES, name,
                                base._replace(out_dir=tmp_path / name))
        out = _build.build(["one", "two"])
        assert events == ["start", "start", "wait", "wait"]
        assert all(p.exists() for p in out.values())

    def test_compiler_output_kept_beside_the_library(self, monkeypatch, tmp_path):
        """The compiler's output is kept beside the library, so a process
        that finds the library built (a second run in the same checkout)
        still has it in BUILD_LOGS."""
        monkeypatch.setitem(_build.SOURCES, "logged", _build.SOURCES["loader"]._replace(
            flags=_build.SOURCES["loader"].flags + ("-v",), out_dir=tmp_path))
        monkeypatch.setattr(_build, "BUILD_LOGS", {})
        lib = _build.build(["logged"])["logged"]
        first = _build.BUILD_LOGS["logged"]
        assert "-v" in first or "gcc version" in first
        assert lib.with_suffix(".log").read_text() == first
        monkeypatch.setattr(_build, "BUILD_LOGS", {})
        assert _build.build(["logged"])["logged"] == lib
        assert _build.BUILD_LOGS == {"logged": first}

    def test_available_says_native_once(self, monkeypatch, caplog):
        monkeypatch.setattr(native, "_AVAILABLE", None)
        with caplog.at_level(logging.INFO, logger="mav_detection_tpu_torch.runtime"):
            assert native.available() and native.available()
        assert caplog.text.count("read with the native loader") == 1


class TestNativeCodec:
    def test_read_parity(self, flo_dir):
        np.testing.assert_array_equal(native.read_flow(flo_dir[0]),
                                      tflo.read_flow(flo_dir[0]))
        assert native.probe(flo_dir[0]) == (60, 40)

    def test_write_parity(self, flo_dir, tmp_path):
        f = tflo.read_flow(flo_dir[1])
        a, b = str(tmp_path / "n.flo"), str(tmp_path / "p.flo")
        native.write_flow(a, f)
        tflo.write_flow(b, f)
        assert Path(a).read_bytes() == Path(b).read_bytes()
        np.testing.assert_array_equal(tflo.read_flow(a), f)
        with pytest.raises(ValueError, match="expected"):
            native.write_flow(a, np.zeros((4, 4), np.float32))

    def test_batch(self, flo_dir):
        batch = native.read_flow_batch(flo_dir, n_threads=3)
        assert batch.shape == (12, 40, 60, 2)
        for i in (0, 5, 11):
            np.testing.assert_array_equal(batch[i], tflo.read_flow(flo_dir[i]))
        assert native.read_flow_batch([]).shape == (0, 0, 0, 2)

    def test_core_read_flow_batch_goes_native(self, flo_dir, monkeypatch):
        calls = []
        real = native.read_flow_batch
        monkeypatch.setattr(native, "read_flow_batch",
                            lambda p, **k: calls.append(len(p)) or real(p, **k))
        batch = tflo.read_flow_batch(tuple(flo_dir[:4]))
        assert calls == [4] and batch.shape == (4, 40, 60, 2)
        for i in range(4):
            np.testing.assert_array_equal(batch[i], tflo.read_flow(flo_dir[i]))

    def test_corrupt_file_raises(self, tmp_path):
        bad = str(tmp_path / "bad.flo")
        with open(bad, "wb") as f:
            f.write(b"garbage")
        with pytest.raises(IOError):
            native.read_flow(bad)
        with pytest.raises(IOError):
            native.probe(str(tmp_path / "missing.flo"))

    def test_wrong_shape_batch_raises(self, flo_dir, tmp_path):
        odd = str(tmp_path / "odd.flo")
        tflo.write_flow(odd, np.zeros((8, 8, 2), np.float32))
        with pytest.raises(IOError):
            native.read_flow_batch([flo_dir[0], odd])

    def test_truncated_batch_read_raises(self, flo_dir, tmp_path):
        bad = str(tmp_path / "trunc.flo")
        shutil.copy(flo_dir[0], bad)
        with open(bad, "r+b") as f:
            f.truncate(12 + 100)
        with pytest.raises(IOError):
            native.read_flow_batch([flo_dir[0], bad])
        with pytest.raises(IOError):
            tflo.read_flow_batch([flo_dir[0], bad])


class TestPrefetcher:
    def test_in_order_complete(self, flo_dir):
        pf = native.FloPrefetcher(flo_dir, depth=3, n_threads=2)
        got = list(pf)
        pf.close()
        assert len(got) == len(flo_dir)
        for g, p in zip(got, flo_dir):
            np.testing.assert_array_equal(g, tflo.read_flow(p))

    def test_early_close_no_hang(self, flo_dir):
        pf = native.FloPrefetcher(flo_dir, depth=2, n_threads=2)
        next(pf)
        pf.close()  # must not deadlock with producers mid-flight
        pf.close()
        assert pf.inflight() == 0
        with pytest.raises(StopIteration):
            next(pf)

    def test_depth_bounds_memory(self, flo_dir):
        """A lagging consumer must not let producers run ahead: in-flight
        (claimed-but-unconsumed) items stay <= depth even with more threads
        than depth and a stalled consumer."""
        pf = native.FloPrefetcher(flo_dir, depth=3, n_threads=4)
        time.sleep(0.3)  # consumer stalls; producers would race ahead
        assert pf.inflight() <= 3
        next(pf)
        time.sleep(0.1)
        assert pf.inflight() <= 3
        rest = list(pf)
        pf.close()
        assert len(rest) == len(flo_dir) - 1

    def test_inflight_drains_to_zero(self, flo_dir):
        pf = native.FloPrefetcher(flo_dir, depth=2, n_threads=2)
        for _ in range(len(flo_dir)):
            next(pf)
        assert pf.inflight() == 0
        pf.close()

    def test_bad_middle_file_raises_not_zeros(self, flo_dir, tmp_path):
        """A truncated file surfaces as IOError when its slot is delivered,
        never as a silent all-zero flow frame."""
        d = tmp_path / "seq"
        d.mkdir()
        paths = []
        for i, src in enumerate(flo_dir[:5]):
            p = str(d / f"{i:06d}.flo")
            shutil.copy(src, p)
            paths.append(p)
        with open(paths[2], "r+b") as f:
            f.truncate(12 + 40 * 60 * 2 * 2)  # header + half the floats
        pf = native.FloPrefetcher(paths, depth=2, n_threads=2)
        a = next(pf)
        b = next(pf)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        with pytest.raises(IOError):
            next(pf)
        pf.close()

    def test_no_paths_refused(self):
        with pytest.raises(ValueError, match="no paths"):
            native.FloPrefetcher([])


# ------------------------------------------------------- inside the Processor
def _disk_processor(tmp, flow_source, batch=2):
    """A Processor over a materialised sequence whose PRECOMPUTED files
    (``%06d.flo``, written by the native writer) and ground-truth files lie
    on disk; the in-memory getters are removed, so the files are what is
    read."""
    cfg = RunConfig(dataset="synthetic", flow_source=flow_source, batch_size=batch)
    cfg.get_dataset = lambda **_: SyntheticDataset(
        params=SyntheticParams(**SMALL), materialize_to=str(tmp))
    proc = Processor(cfg, device="cpu")
    proc.save_images = False
    ds = proc.dataset
    ds.gt_of_path = os.path.join(ds.seq_path, "optical-flow")
    ds.flow_path = os.path.join(ds.seq_path, "flow")
    os.makedirs(ds.flow_path, exist_ok=True)
    for i in range(ds.N - 1):
        native.write_flow(os.path.join(ds.flow_path, f"{i:06d}.flo"), ds.flows[i])
    return proc


@pytest.mark.parametrize("flow_source", ["PRECOMPUTED", "GROUND_TRUTH"])
def test_processor_reads_through_the_prefetcher(flow_source, tmp_path, monkeypatch):
    """The run arms the prefetcher (depth max(2 * batch, 4), 2 threads),
    takes every file from it in order, closes it, and gives the same
    FrameResults as the run whose flow comes from the numpy reader."""
    made = []
    real = native.FloPrefetcher

    class Watched(real):
        def __init__(self, paths, depth, n_threads):
            made.append(dict(n=len(paths), depth=depth, n_threads=n_threads, served=0))
            super().__init__(paths, depth=depth, n_threads=n_threads)

        def __next__(self):
            out = super().__next__()
            made[-1]["served"] += 1
            return out

    monkeypatch.setattr(native, "FloPrefetcher", Watched)
    proc = _disk_processor(tmp_path / "a", flow_source)
    res = proc.run_detection_foe()
    n = SMALL["n_frames"] - 1
    assert made == [dict(n=n, depth=4, n_threads=2, served=n)]
    assert proc._flo_prefetcher is None              # closed after the run

    monkeypatch.setattr(native, "available", lambda: False)
    plain = _disk_processor(tmp_path / "b", flow_source)
    ref = plain.run_detection_foe()
    assert len(made) == 1 and sorted(res) == sorted(ref) == list(range(n))
    for i in ref:
        assert res[i].to_json() == ref[i].to_json()


def test_in_memory_dataset_arms_no_prefetcher(monkeypatch):
    made = []
    monkeypatch.setattr(native, "FloPrefetcher",
                        lambda *a, **k: made.append(1))
    cfg = RunConfig(dataset="synthetic", flow_source="PRECOMPUTED", batch_size=2)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=SyntheticParams(**SMALL))
    proc = Processor(cfg, device="cpu")
    assert len(proc.run_detection_foe()) == SMALL["n_frames"] - 1 and not made


def test_prefetcher_is_rearmed_per_run_and_released(tmp_path):
    proc = _disk_processor(tmp_path, "PRECOMPUTED")
    a = {i: fr.to_json() for i, fr in proc.run_detection_foe().items()}
    b = {i: fr.to_json() for i, fr in proc.run_detection_foe().items()}
    assert a == b
    # a run that stopped mid-sequence leaves one armed: release() closes it
    proc._open_flo_prefetcher(SMALL["n_frames"] - 1, proc.config.flow_source)
    held = proc._flo_prefetcher
    assert held is not None and held._handle
    proc.release()
    assert proc._flo_prefetcher is None and held._handle is None


def test_truncated_file_fails_the_run(tmp_path):
    proc = _disk_processor(tmp_path, "PRECOMPUTED")
    with open(os.path.join(proc.dataset.flow_path, "000002.flo"), "r+b") as f:
        f.truncate(12 + 100)
    with pytest.raises(IOError, match="#2"):
        proc.run_detection_foe()
    assert proc._flo_prefetcher is None

"""The PyTorch port stands alone: it imports neither JAX, the JAX package,
Flax, msgpack nor OpenCV, and its entry points run on the card or raise (no
CPU fallback)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "mav_detection_tpu_torch"

# an import statement of jax, cv2 or the JAX package (not the port itself)
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|cv2|mav_detection_tpu)(?:[.\s,]|$)",
    re.MULTILINE)
# chip_smoke.py may import cv2 inside a function (the oracle of its EPE
# gates, computed where the chip machine has cv2); the package may not,
# and test_import_every_module_without_jax_or_cv2 keeps it out of
# sys.modules when chip_smoke is imported
_FORBIDDEN_IN_SCRIPT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|mav_detection_tpu)(?:[.\s,]|$)|^(?:import|from)\s+cv2",
    re.MULTILINE)


# a Flax, msgpack, optax or orbax import: the port reads and writes the
# checkpoints with its own code and has its own optimizer chains
_NO_FLAX = re.compile(r"^\s*(?:import|from)\s+(?:flax|msgpack|optax|orbax)(?:[.\s,]|$)",
                      re.MULTILINE)


# the modules of the single-card Processor surface beyond the FoE loop, the
# scan engine, the native runtime, the entry point, and the learned nets
NEW_MODULES = [
    "mav_detection_tpu_torch.ops.image.visualize",
    "mav_detection_tpu_torch.ops.image.resize",
    "mav_detection_tpu_torch.ops.image.color",
    "mav_detection_tpu_torch.ops.geometry.warp",
    "mav_detection_tpu_torch.ops.geometry.global_motion",
    "mav_detection_tpu_torch.ops.geometry.ransac_fits",
    "mav_detection_tpu_torch.ops.geometry.kmeans",
    "mav_detection_tpu_torch.ops.geometry.boxsearch",
    "mav_detection_tpu_torch.ops.flow.lucas_kanade",
    "mav_detection_tpu_torch.pipeline.temporal",
    "mav_detection_tpu_torch.runtime.native_loader",
    "mav_detection_tpu_torch.entry",
    "mav_detection_tpu_torch.convert",
    "mav_detection_tpu_torch.models.checkpoint",
    "mav_detection_tpu_torch.models.pretrained",
    "mav_detection_tpu_torch.models.layers",
    "mav_detection_tpu_torch.models.sky_segmentation",
    "mav_detection_tpu_torch.models.raft",
    "mav_detection_tpu_torch.data.preprocessing",
    "mav_detection_tpu_torch.data.midgard",
    "mav_detection_tpu_torch.data.vis_drone",
    "mav_detection_tpu_torch.data.experiment",
    "mav_detection_tpu_torch.data.airsim_flow",
    "mav_detection_tpu_torch.data.sim_data",
    "mav_detection_tpu_torch.sim.client",
    "mav_detection_tpu_torch.sim.control",
    "mav_detection_tpu_torch.sim.sim_config",
    "mav_detection_tpu_torch.cli.collect",
    "mav_detection_tpu_torch.models.yolo",
    "mav_detection_tpu_torch.pipeline.mode_imagery",
    "mav_detection_tpu_torch.eval.validator",
    "mav_detection_tpu_torch.serve",
    "mav_detection_tpu_torch.cli.serve",
    "mav_detection_tpu_torch.data.synthgen",
    "mav_detection_tpu_torch.models.optim",
    "mav_detection_tpu_torch.cli.train",
    "mav_detection_tpu_torch.cli.demo",
    "mav_detection_tpu_torch.cli.video",
    "mav_detection_tpu_torch.eval.figures",
    "mav_detection_tpu_torch.parallel.mesh",
    "mav_detection_tpu_torch.parallel.halo",
    "mav_detection_tpu_torch.parallel.spatial",
    "mav_detection_tpu_torch.ops.flow.shift_probes",
    "mav_detection_tpu_torch.utils.timing",
    "mav_detection_tpu_torch.tools.gather_probe",
    "mav_detection_tpu_torch.tools.chain_probe",
    "mav_detection_tpu_torch.tools.batch_overhead_probe",
    "mav_detection_tpu_torch.tools.common",
    "mav_detection_tpu_torch.tools.pipeline_stage_probe",
    "mav_detection_tpu_torch.tools.iter_schedule_sweep",
    "mav_detection_tpu_torch.tools.hires_flow_sweep",
    "mav_detection_tpu_torch.tools.hires_pipeline_probe",
    "mav_detection_tpu_torch.tools.raft_stage_probe",
    "mav_detection_tpu_torch.tools.hires_raft_probe",
    "mav_detection_tpu_torch.tools.hires_lk_probe",
    "mav_detection_tpu_torch.tools.spatial_probe",
    "mav_detection_tpu_torch.tools.cross_domain_eval",
    "mav_detection_tpu_torch.tools.raft_advantage_probe",
    "mav_detection_tpu_torch.tools.hires_eval",
    "mav_detection_tpu_torch.tools.foe_reference_scale",
    "mav_detection_tpu_torch.tools.finetune_raft",
    "mav_detection_tpu_torch.tools.soup_raft",
    "mav_detection_tpu_torch.tools.pan_curriculum",
    "mav_detection_tpu_torch.bench",
]


# an import of the reference's tools/ scripts (they import jax); the port's
# probes are mav_detection_tpu_torch.tools
_NO_REFERENCE_TOOLS = re.compile(r"^\s*(?:import|from)\s+tools(?:[.\s,]|$)",
                                 re.MULTILINE)


# a module-level import of requests or matplotlib: a CUDA host need not
# have either; the Validator imports matplotlib lazily and speaks HTTP with urllib
_NO_TOP_LEVEL_CLIENT_LIBS = re.compile(
    r"^(?:import|from)\s+(?:requests|matplotlib)(?:[.\s,]|$)", re.MULTILINE)


# an imageio or PIL import: the port reads and writes PNGs with its own codec
_NO_IMAGE_LIBS = re.compile(r"^\s*(?:import|from)\s+(?:imageio|PIL)(?:[.\s,]|$)",
                            re.MULTILINE)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_every_module_without_jax_or_cv2():
    """A fresh interpreter imports every module of the port (and
    chip_smoke.py); jax, the JAX package and cv2 stay out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mav_detection_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "missing = sorted(set(%r) - set(mods))\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'mav_detection_tpu', 'cv2', 'flax',\n"
        "              'msgpack', 'optax', 'orbax'))\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n") % (NEW_MODULES,)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_mods = int(proc.stdout.split()[0])
    assert n_mods >= 30, proc.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_forbidden_import(path):
    text = path.read_text()
    pattern = _FORBIDDEN_IN_SCRIPT if path.name == "chip_smoke.py" else _FORBIDDEN
    assert not pattern.findall(text), f"{path}: {pattern.findall(text)}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_flax_nor_msgpack(path):
    text = path.read_text()
    assert not _NO_FLAX.findall(text), f"{path}: {_NO_FLAX.findall(text)}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_imageio_nor_pil(path):
    text = path.read_text()
    assert not _NO_IMAGE_LIBS.findall(text), f"{path}: {_NO_IMAGE_LIBS.findall(text)}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_reference_tool(path):
    text = path.read_text()
    found = _NO_REFERENCE_TOOLS.findall(text)
    assert not found, f"{path}: {found}"


def test_reference_tools_pattern_catches_and_spares():
    assert _NO_REFERENCE_TOOLS.search("from tools import gather_probe")
    assert _NO_REFERENCE_TOOLS.search("    import tools.chain_probe as cp")
    assert not _NO_REFERENCE_TOOLS.search("from mav_detection_tpu_torch.tools import chain_probe")
    assert not _NO_REFERENCE_TOOLS.search("import toolset")
    assert not _NO_REFERENCE_TOOLS.search("# the tools of the reference")


def test_image_lib_pattern_catches_and_spares():
    assert _NO_IMAGE_LIBS.search("import imageio.v3 as iio")
    assert _NO_IMAGE_LIBS.search("    from PIL import Image")
    assert not _NO_IMAGE_LIBS.search("# what imageio returns")
    assert not _NO_IMAGE_LIBS.search("import PILlow_like")


def test_png_unfilter_builds_under_build_native():
    """runtime/native/png.cpp builds with g++ into build/native/, keyed by a
    hash of its source and flags, nothing beside the source."""
    from mav_detection_tpu_torch import _build

    path = _build.build(["png"])["png"]
    assert path.exists() and path.parent == REPO / "build" / "native"
    assert path.name.startswith("libpng-") and path == _build._target(_build.SOURCES["png"])
    assert not list((PKG / "runtime").rglob("*.so"))


def test_no_flax_pattern_catches_and_spares():
    assert _NO_FLAX.search("from flax import serialization")
    assert _NO_FLAX.search("  import msgpack")
    assert not _NO_FLAX.search("# flax writes a msgpack map")
    assert not _NO_FLAX.search("import flaxen")
    assert _NO_FLAX.search("import optax")
    assert _NO_FLAX.search("    import orbax.checkpoint as ocp")


def test_forbidden_pattern_catches_and_spares():
    assert _FORBIDDEN_IN_SCRIPT.search("import jax.numpy as jnp")
    assert _FORBIDDEN_IN_SCRIPT.search("    from mav_detection_tpu.ops import flow")
    assert _FORBIDDEN_IN_SCRIPT.search("import cv2")
    assert not _FORBIDDEN_IN_SCRIPT.search("    import cv2")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from mav_detection_tpu.ops import flow")
    assert _FORBIDDEN.search("import cv2")
    assert not _FORBIDDEN.search("from mav_detection_tpu_torch.ops import flow")
    assert not _FORBIDDEN.search("import jaxtyping_like_name_in_text = 1")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")


def test_processor_defaults_to_card_and_raises_without_one():
    _no_card()
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.pipeline.processor import Processor

    with pytest.raises(RuntimeError, match="cuda"):
        Processor(RunConfig(dataset="synthetic", flow_source="FARNEBACK"))


def test_flow_entry_points_raise_without_card():
    _no_card()
    from mav_detection_tpu_torch.ops.flow import farneback_flow, farneback_flow_batch

    frames = np.zeros((2, 32, 32), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        farneback_flow_batch(frames, frames)
    with pytest.raises(RuntimeError, match="cuda"):
        farneback_flow(frames[0], frames[0])


def test_cli_defaults_to_card_and_raises_without_one():
    _no_card()
    from mav_detection_tpu_torch.cli.main import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--dataset", "synthetic", "--flow-source", "FARNEBACK",
              "--headless"])


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """No toolkit: the build raises rather than falling back."""
    from mav_detection_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_iterate_wrapper_rejects_other_devices():
    from mav_detection_tpu_torch.ops.flow import farneback_iterate

    t = torch.zeros((1, 5, 8, 8), device="meta")
    f = torch.zeros((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        farneback_iterate(t, t, f, torch.zeros((8, 8), device="meta"), 1)


@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_module_is_part_of_the_port(name):
    assert (REPO / (name.replace(".", "/") + ".py")).is_file()


def test_image_io_needs_no_imageio():
    """PNG reading and writing is the port's own codec: a fresh interpreter
    writes and reads an image with imageio, PIL and cv2 barred."""
    code = (
        "import sys\n"
        "for m in ('imageio', 'PIL', 'cv2'): sys.modules[m] = None\n"
        "import numpy as np\n"
        "from mav_detection_tpu_torch.data.dataset import imread, imwrite\n"
        "img = (np.arange(5 * 7 * 3) %% 251).reshape(5, 7, 3).astype(np.uint8)\n"
        "imwrite(%r, img)\n"
        "assert (imread(%r) == img).all()\n")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.png")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-c", code % (path, path)],
                              cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_new_entry_points_raise_without_card():
    """The homography branch and the LK source run on the card by default."""
    _no_card()
    from mav_detection_tpu_torch.cli.main import main

    for argv in (["--algorithm", "HOMOGRAPHY", "--flow-source", "FARNEBACK"],
                 ["--flow-source", "LUCAS_KANADE"],
                 ["--flow-source", "FARNEBACK", "--engine", "scan"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--dataset", "synthetic", "--headless", *argv])
    from mav_detection_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="cuda"):
        entry()


def test_net_entry_points_raise_without_card():
    """RAFT, the SkyUNet and a Processor on the RAFT source run on the card
    by default."""
    _no_card()
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.models.raft import (
        raft_flow_batch,
        raft_flow_batch_tuned,
        raft_flow_video_tuned,
    )
    from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet, sky_mask
    from mav_detection_tpu_torch.pipeline.processor import Processor

    frames = np.zeros((2, 64, 64, 3), np.uint8)
    for call in (lambda: raft_flow_batch(frames[:1], frames[1:]),
                 lambda: raft_flow_batch_tuned(frames[:1], frames[1:]),
                 lambda: raft_flow_video_tuned(frames),
                 lambda: sky_mask(SkyUNet(), frames[0]),
                 lambda: Processor(RunConfig(dataset="synthetic", flow_source="RAFT"))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    from mav_detection_tpu_torch.cli.main import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--dataset", "synthetic", "--headless", "--flow-source", "RAFT"])


def test_checkpoints_load_with_flax_and_msgpack_barred():
    """A fresh interpreter reads, migrates and converts both shipped
    checkpoints with flax and msgpack unimportable."""
    code = (
        "import sys\n"
        "for m in ('flax', 'msgpack', 'jax'): sys.modules[m] = None\n"
        "from mav_detection_tpu_torch.models import pretrained\n"
        "raft = pretrained.load_raft('cpu'); sky = pretrained.load_sky('cpu')\n"
        "assert raft is not None and sky is not None\n"
        "assert raft.mask_hidden.weight.shape == (128, 96, 3, 3)\n"
        "print(sum(p.numel() for p in raft.parameters()),\n"
        "      sum(p.numel() for p in sky.parameters()))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MAV_CHECKPOINT_PATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_raft, n_sky = (int(v) for v in proc.stdout.split())
    assert n_raft > 1_000_000 and n_sky > 100_000


def test_dataset_device_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """A SimDataset synthesises its GT flow on ``Dataset.device``, the card
    unless the caller passes another; a MIDGARD sequence without HRNet masks
    runs its SkyUNet there."""
    _no_card()
    from mav_detection_tpu_torch.data import MidgardDataset, SimDataset
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.sim import MockSimClient, SimDataCollector

    collection = {
        "orientations": ["north"], "locations": {"field": {"x": 0.0, "y": 0.0, "z": -2.0}},
        "orbit_speed": [2.0], "heights": {"low": 3.0}, "radii": [15.0],
        "global_speed": {"default": {"lin_x": 1.2, "sin_y": 0.0, "sin_z": 0.0}},
        "modes": ["foe_demo"], "collision_angles": [0.0]}
    col = SimDataCollector(MockSimClient(image_hw=(24, 32)), collection,
                           root_data_dir=str(tmp_path / "sim"), max_iterations=2)
    col.run()
    monkeypatch.setenv("SIMDATA_PATH", str(tmp_path / "sim"))
    seq = os.path.relpath(col.get_base_dir(col.configs[0]), tmp_path / "sim")
    with pytest.raises(RuntimeError, match="cuda"):
        SimDataset(sequence=seq)
    assert SimDataset(sequence=seq, device="cpu").N == 2

    SyntheticDataset(sequence="countryside-natural/north-narrow",
                     params=SyntheticParams(height=24, width=32, n_frames=2),
                     materialize_to=str(tmp_path / "mg"))
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path / "mg"))
    mg = MidgardDataset()
    assert mg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        mg.get_sky_segmentation(0)


def test_cli_default_dataset_runs_on_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """The bare CLI (MIDGARD, PRECOMPUTED) defaults to the card."""
    _no_card()
    from mav_detection_tpu_torch.cli.main import main
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams

    SyntheticDataset(sequence="countryside-natural/north-narrow",
                     params=SyntheticParams(height=24, width=32, n_frames=2),
                     materialize_to=str(tmp_path))
    monkeypatch.setenv("MIDGARD_PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--headless"])


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_requests_nor_matplotlib_at_module_level(path):
    text = path.read_text()
    found = _NO_TOP_LEVEL_CLIENT_LIBS.findall(text)
    assert not found, f"{path}: {found}"


def test_client_lib_pattern_catches_and_spares():
    assert _NO_TOP_LEVEL_CLIENT_LIBS.search("import requests")
    assert _NO_TOP_LEVEL_CLIENT_LIBS.search("import matplotlib.pyplot as plt")
    assert _NO_TOP_LEVEL_CLIENT_LIBS.search("from matplotlib import cm")
    assert not _NO_TOP_LEVEL_CLIENT_LIBS.search("        import matplotlib")
    assert not _NO_TOP_LEVEL_CLIENT_LIBS.search("# requests go through urllib")


def test_every_module_imports_with_requests_and_matplotlib_barred():
    """A fresh interpreter with requests and matplotlib unimportable imports
    every module of the port and chip_smoke.py, and runs the Validator's
    figure step (skipped, with its warning)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('requests', 'matplotlib'): sys.modules[m] = None\n"
        "import mav_detection_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from mav_detection_tpu_torch.core.config import RunConfig\n"
        "from mav_detection_tpu_torch.eval.validator import Validator\n"
        "assert Validator(RunConfig(dataset='synthetic'), device='cpu')._plt() is None\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "matplotlib cannot be imported" in proc.stderr


def test_yolo_entry_points_raise_without_card(tmp_path, monkeypatch):
    """TinyYOLO, the Validator, the server and the CLI's validation run on
    the card by default."""
    _no_card()
    from mav_detection_tpu_torch.cli.main import main
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.eval.validator import Validator
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.serve import create_server

    for call in (lambda: pretrained.load_yolo("FLOW_UV"),
                 lambda: Validator(RunConfig(dataset="synthetic")),
                 lambda: create_server(port=0)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    monkeypatch.chdir(tmp_path)
    for argv in (["--validate"], ["--prepare-dataset"], ["--data-to-yolo"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--dataset", "synthetic", "--headless", *argv])


def test_spawned_ranks_never_import_jax(tmp_path):
    """The multi-device paths spawn their ranks from the port's own rank
    functions: with ``jax`` and the JAX package made unimportable for the
    caller and every rank it spawns (stand-ins first on PYTHONPATH, which
    the ranks inherit), ``dryrun_multichip`` runs every stage on 2 gloo
    ranks."""
    for name in ("jax", "mav_detection_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is barred here')\n")
    code = ("import torch\n"
            "torch.set_num_threads(1)\n"
            "from mav_detection_tpu_torch.entry import dryrun_multichip\n"
            "if __name__ == '__main__':\n"
            "    assert len(dryrun_multichip(2, 'cpu')) == 6\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raft train step ok" in proc.stdout


def test_multi_device_entry_points_raise_without_card():
    """The pretrained loaders, the sharded Processor and
    ``dryrun_multichip`` run on the card by default (the data-parallel
    trainer: tests/test_torch_train.py)."""
    _no_card()
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.entry import dryrun_multichip
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.pipeline.processor import Processor

    for call in (pretrained.load_raft, pretrained.load_sky,
                 lambda: dryrun_multichip(2),
                 lambda: Processor(RunConfig(dataset="synthetic", devices=2,
                                             flow_source="FARNEBACK"))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()

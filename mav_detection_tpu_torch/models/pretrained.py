"""The shipped weights of the learned nets
(``mav_detection_tpu.models.pretrained``): one Flax msgpack file per model
under ``checkpoints/`` (another root with ``MAV_CHECKPOINT_PATH``), read by
the port's own reader (``models/checkpoint.py``) and carried into each
model's ``state_dict`` by ``convert.py``.

The reference restores into a template built by ``model.init``; the port
needs none (the conversion names every key and refuses leftovers). Loaders
return None when the file is missing. What was loaded is cached for the
process: the ``state_dict`` on the CPU, and each model once per device;
``clear_cache`` drops all of it.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Optional, Union

import torch

from mav_detection_tpu_torch.models import checkpoint

logger = logging.getLogger("mav_detection_tpu_torch")

_CACHE: dict = {}


def checkpoint_root() -> str:
    env = os.environ.get("MAV_CHECKPOINT_PATH")
    if env:
        return env
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "checkpoints")


def checkpoint_path(name: str) -> str:
    return os.path.join(checkpoint_root(), f"{name}.msgpack")


def has_checkpoint(name: str) -> bool:
    return os.path.exists(checkpoint_path(name))


def _migrate_raft_state(state: Any) -> Any:
    """Pre-mask-hoist checkpoints kept the convex-upsample mask head inside
    the per-iteration update block (refine/update/{Conv_6, mask_head}); it
    now lives at the RAFT level as mask_hidden/mask_head. Pure key move,
    weights unchanged; Conv_0..Conv_5 keep their numbers because the hoisted
    conv was the last anonymous one."""
    p = state.get("params", state)
    upd = p.get("refine", {}).get("update", {})
    if "mask_head" in upd:
        p["mask_head"] = upd.pop("mask_head")
        p["mask_hidden"] = upd.pop("Conv_6")
        logger.info("migrated pre-hoist RAFT checkpoint layout "
                    "(refine/update mask head -> top-level)")
    return state


def _load_state_dict(name: str, convert: Callable[[Any], Dict[str, torch.Tensor]],
                     migrate=None) -> Optional[Dict[str, torch.Tensor]]:
    if name in _CACHE:
        return _CACHE[name]
    path = checkpoint_path(name)
    if not os.path.exists(path):
        return None
    params = convert(checkpoint.load_msgpack(path, migrate=migrate))
    _CACHE[name] = params
    logger.info(f"loaded {name} weights from {path}")
    return params


def load_raft_params() -> Optional[Dict[str, torch.Tensor]]:
    """The shipped RAFT weights as the port's ``state_dict`` (CPU, fp32), or
    None when no checkpoint is shipped."""
    from mav_detection_tpu_torch.convert import raft_state_dict_from_flax

    return _load_state_dict("raft", raft_state_dict_from_flax,
                            migrate=_migrate_raft_state)


def load_sky_params() -> Optional[Dict[str, torch.Tensor]]:
    """The shipped SkyUNet weights as the port's ``state_dict``, or None."""
    from mav_detection_tpu_torch.convert import sky_state_dict_from_flax

    return _load_state_dict("sky", sky_state_dict_from_flax)


def _model_on(name: str, device: torch.device, build: Callable[[], torch.nn.Module],
              load: Callable[[], Optional[Dict[str, torch.Tensor]]]):
    key = (name, str(device))
    if key not in _CACHE:
        params = load()
        if params is None:
            return None
        with torch.device("meta"):
            model = build()
        model.load_state_dict({k: v.to(device) for k, v in params.items()},
                              assign=True)
        _CACHE[key] = model
    return _CACHE[key]


def load_raft(device: Union[str, torch.device] = "cuda"):
    """The shipped RAFT as a ``models.raft.RAFT`` on ``device``, or None.
    Raises without a card unless ``device="cpu"``."""
    from mav_detection_tpu_torch.models.raft import RAFT
    from mav_detection_tpu_torch.utils.device import resolve_device

    return _model_on("raft", resolve_device(device), RAFT, load_raft_params)


def load_sky(device: Union[str, torch.device] = "cuda"):
    """The shipped SkyUNet on ``device``, or None. Raises without a card
    unless ``device="cpu"``."""
    from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet
    from mav_detection_tpu_torch.utils.device import resolve_device

    return _model_on("sky", resolve_device(device), SkyUNet, load_sky_params)


def yolo_checkpoint_name(mode: Optional[str] = None) -> str:
    """Checkpoint name for a detection mode: ``yolo`` for APPEARANCE_RGB,
    ``yolo_flow_uv`` etc. for the flow-imagery modes."""
    if not mode or mode == "APPEARANCE_RGB":
        return "yolo"
    return f"yolo_{mode.lower()}"


def resolve_yolo_checkpoint(mode: Optional[str] = None) -> str:
    """Path of the checkpoint a mode's detector would use: the per-mode file
    when shipped, else the RGB-trained fallback."""
    path = checkpoint_path(yolo_checkpoint_name(mode))
    if os.path.exists(path):
        return path
    return checkpoint_path("yolo")


def load_yolo_params(mode: Optional[str] = None) -> Optional[Dict[str, torch.Tensor]]:
    """TinyYOLO weights for a detection mode as the port's ``state_dict``,
    falling back (with a WARNING) to the RGB-trained weights when no
    per-mode checkpoint is shipped; None when neither file exists."""
    from mav_detection_tpu_torch.convert import yolo_state_dict_from_flax

    name = yolo_checkpoint_name(mode)
    path = checkpoint_path(name)
    if not os.path.exists(path):
        if name != "yolo":
            logger.warning(
                f"no per-mode YOLO checkpoint {path}; falling back to the "
                "RGB-trained weights (the JAX package trains mode weights "
                f"with `python -m mav_detection_tpu.cli.train --model yolo "
                f"--yolo-mode {mode}`)")
            return load_yolo_params(None)
        return None
    return _load_state_dict(name, yolo_state_dict_from_flax)


def load_yolo(mode: Optional[str] = None,
              device: Union[str, torch.device] = "cuda"):
    """The TinyYOLO of a detection mode on ``device``, or None. Cached per
    device under the name of the checkpoint it was read from, so the RGB
    fallback and a per-mode file never share an entry."""
    from mav_detection_tpu_torch.models.yolo import TinyYOLO
    from mav_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    name = os.path.splitext(os.path.basename(resolve_yolo_checkpoint(mode)))[0]
    return _model_on(name, dev, TinyYOLO, lambda: load_yolo_params(mode))


def clear_cache() -> None:
    _CACHE.clear()

"""Carry the reference's configuration state into the port.

The Farneback + FoE path has no learned weights: its state is the numpy
matrices (built by the copied builders in ``ops/flow/farneback.py``, bit
equal to the reference's) and the ``FarnebackParams`` / ``DetectionStep``
settings. These converters take the reference's settings as plain dicts
(``dataclasses.asdict(params)``, ``step._asdict()``) so one description
configures both packages. The carried state of the sparse path (the trace
ring, the flow history, the feature pool, corners and tracks) crosses as
dicts of numpy arrays (``{k: np.asarray(v) for k, v in state._asdict()
.items()}`` on the reference's side, ``state_to_numpy`` on the port's).

The learned nets' weights cross as the raw Flax param tree (nested dicts of
numpy arrays: what ``models/checkpoint.py`` reads, and what
``flax.serialization.msgpack_restore`` returns): ``raft_state_dict_from_flax``,
``sky_state_dict_from_flax`` and ``yolo_state_dict_from_flax`` give each
model's ``state_dict``. Conv ``kernel`` HWIO becomes ``weight`` OIHW,
GroupNorm ``scale`` becomes ``weight``, and Flax's automatic names map to the
port's module names by the tables below. A key left over on either side
raises. ``flax_from_raft_state_dict``, ``flax_from_sky_state_dict`` and
``flax_from_yolo_state_dict`` go back by the same tables: a net the port
trained becomes the ``{"params": ...}`` tree the JAX package reads (RAFT in
the post-hoist layout).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams
from mav_detection_tpu_torch.ops.flow.lucas_kanade import (
    Corners,
    FeaturePool,
    TrackResult,
)
from mav_detection_tpu_torch.ops.geometry.boxsearch import FlowHistory
from mav_detection_tpu_torch.ops.geometry.foe import TraceState
from mav_detection_tpu_torch.pipeline.detector import DetectionStep

# reference knobs that only pick a TPU lowering, not the result
_TPU_ONLY = ("band_rows", "pallas_halo")


def farneback_params_from_reference(d: Mapping[str, Any]) -> FarnebackParams:
    """The port's ``FarnebackParams`` for a reference ``FarnebackParams``
    given as a dict. ``warp`` and ``fast`` carry over, the reference's
    ``warp="pallas"`` under the port's name for the fused iteration,
    ``"fused"``; the TPU lowering knobs are dropped. Reduced matmul precision
    is not ported and raises."""
    if d.get("precision", "highest") != "highest":
        raise NotImplementedError("the port runs every matmul in full fp32")
    known = set(FarnebackParams.__dataclass_fields__)
    unknown = set(d) - known - {"precision", *_TPU_ONLY}
    if unknown:
        raise ValueError(f"unknown FarnebackParams fields: {sorted(unknown)}")
    kw = {k: v for k, v in d.items() if k in known}
    if kw.get("warp") == "pallas":
        kw["warp"] = "fused"
    if kw.get("level_iters") is not None:
        kw["level_iters"] = tuple(kw["level_iters"])
    return FarnebackParams(**kw)


def detection_step_from_reference(d: Mapping[str, Any]) -> DetectionStep:
    """The port's ``DetectionStep`` for a reference one given as a dict
    (``batch_mode`` picks a JAX vectorization and does not change results)."""
    if d.get("batch_mode", "vmap") not in ("vmap", "map"):
        raise ValueError(f"unknown batch_mode {d['batch_mode']!r}")
    return DetectionStep(foe_samples=int(d.get("foe_samples", 1000)))


# ------------------------------------------------- carried state, as numpy
Device = Union[str, torch.device]


def _tensor(d: Mapping[str, Any], key: str, dtype: torch.dtype,
            device: Device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(d[key]), device=device).to(dtype)


def state_to_numpy(state: NamedTuple) -> Dict[str, np.ndarray]:
    """Any of the port's state tuples as a dict of numpy arrays, with the
    reference's field names."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in state._asdict().items()}


def trace_state_from_reference(d: Mapping[str, Any],
                               device: Device = "cpu") -> TraceState:
    return TraceState(
        positions=_tensor(d, "positions", torch.float32, device),
        alive=_tensor(d, "alive", torch.bool, device),
        age=_tensor(d, "age", torch.int32, device),
        head=int(np.asarray(d["head"])))


def flow_history_from_reference(d: Mapping[str, Any],
                                device: Device = "cpu") -> FlowHistory:
    return FlowHistory(buffer=_tensor(d, "buffer", torch.float32, device),
                       index=int(np.asarray(d["index"])))


def feature_pool_from_reference(d: Mapping[str, Any],
                                device: Device = "cpu") -> FeaturePool:
    return FeaturePool(points=_tensor(d, "points", torch.float32, device),
                       valid=_tensor(d, "valid", torch.bool, device))


def corners_from_reference(d: Mapping[str, Any],
                           device: Device = "cpu") -> Corners:
    return Corners(points=_tensor(d, "points", torch.float32, device),
                   valid=_tensor(d, "valid", torch.bool, device),
                   response=_tensor(d, "response", torch.float32, device))


def track_result_from_reference(d: Mapping[str, Any],
                                device: Device = "cpu") -> TrackResult:
    return TrackResult(points=_tensor(d, "points", torch.float32, device),
                       status=_tensor(d, "status", torch.bool, device),
                       error=_tensor(d, "error", torch.float32, device))


# ------------------------------------------------- Flax weights of the nets
# Flax module name -> (port module name, table of its children); a child
# table of None means the module holds the leaves (kernel/bias/scale)
_RESIDUAL = {"Conv_0": ("conv1", None), "GroupNorm_0": ("norm1", None),
             "Conv_1": ("conv2", None), "GroupNorm_1": ("norm2", None),
             "Conv_2": ("down", None)}
_ENCODER = {"Conv_0": ("stem", None), "GroupNorm_0": ("stem_norm", None),
            "ResidualBlock_0": ("layer1", _RESIDUAL),
            "ResidualBlock_1": ("layer2", _RESIDUAL),
            "ResidualBlock_2": ("layer3", _RESIDUAL),
            "Conv_1": ("out", None)}
_GRU = {"Conv_0": ("convz", None), "Conv_1": ("convr", None),
        "Conv_2": ("convq", None)}
_UPDATE = {"Conv_0": ("corr1", None), "Conv_1": ("corr2", None),
           "Conv_2": ("flow1", None), "Conv_3": ("flow2", None),
           "Conv_4": ("motion", None), "ConvGRU_0": ("gru", _GRU),
           "Conv_5": ("flow_hidden", None), "flow_head": ("flow_head", None)}
RAFT_TABLE = {"fnet": ("fnet", _ENCODER), "cnet": ("cnet", _ENCODER),
              # the nn.scan'd refinement step holds the update block
              "refine": ("", {"update": ("update", _UPDATE)}),
              "mask_hidden": ("mask_hidden", None),
              "mask_head": ("mask_head", None)}

_BLOCK = {"Conv_0": ("conv1", None), "GroupNorm_0": ("norm1", None),
          "Conv_1": ("conv2", None), "GroupNorm_1": ("norm2", None)}
SKY_TABLE = {"ConvBlock_0": ("down1", _BLOCK), "ConvBlock_1": ("down2", _BLOCK),
             "ConvBlock_2": ("down3", _BLOCK), "ConvBlock_3": ("bottom", _BLOCK),
             "ConvBlock_4": ("up3", _BLOCK), "ConvBlock_5": ("up2", _BLOCK),
             "ConvBlock_6": ("up1", _BLOCK), "Conv_0": ("head", None)}

# TinyYOLO numbers its convs and norms across its four stages: stage s holds
# Conv_{2s}, GroupNorm_{2s} (the stride-2 conv and its norm) and Conv_{2s+1},
# GroupNorm_{2s+1}; Conv_8 is the 1x1 head
YOLO_TABLE = {"Conv_8": ("head", None)}
for _s in range(4):
    YOLO_TABLE.update({
        f"Conv_{2 * _s}": (f"stage{_s + 1}.down", None),
        f"GroupNorm_{2 * _s}": (f"stage{_s + 1}.norm1", None),
        f"Conv_{2 * _s + 1}": (f"stage{_s + 1}.conv", None),
        f"GroupNorm_{2 * _s + 1}": (f"stage{_s + 1}.norm2", None)})


def _leaf(name: str, arr: np.ndarray) -> "tuple[str, torch.Tensor]":
    arr = np.asarray(arr, np.float32)
    if name == "kernel":                       # HWIO -> OIHW
        return "weight", torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
    if name == "scale":
        return "weight", torch.from_numpy(arr.copy())
    if name == "bias":
        return "bias", torch.from_numpy(arr.copy())
    raise KeyError(name)


def _map_tree(tree: Mapping[str, Any], table: Optional[dict], prefix: str,
              path: str, out: Dict[str, torch.Tensor]) -> None:
    for key, sub in tree.items():
        where = f"{path}/{key}"
        if table is None:
            try:
                name, tensor = _leaf(key, sub)
            except KeyError:
                raise ValueError(f"unexpected Flax leaf {where}") from None
            out[prefix + name] = tensor
            continue
        if key not in table:
            raise ValueError(f"Flax module {where} has no counterpart in the port")
        port, children = table[key]
        _map_tree(sub, children, prefix + (port + "." if port else ""), where, out)


def _state_dict_from_flax(tree: Mapping[str, Any], table: dict,
                          model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    _map_tree(params, table, "", "params", out)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise ValueError(f"weights do not match the port's model: missing "
                         f"{missing}, left over {extra}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: Flax shape {tuple(v.shape)}, port "
                             f"{tuple(expected[k].shape)}")
    return out


def raft_state_dict_from_flax(tree: Mapping[str, Any],
                              config=None) -> Dict[str, torch.Tensor]:
    """The ``models.raft.RAFT`` state_dict of a RAFT param tree in the
    post-hoist layout (``pretrained._migrate_raft_state`` moves older
    checkpoints there); ``config`` (a ``RAFTConfig``, the default when None)
    gives the architecture the shapes are checked against."""
    from mav_detection_tpu_torch.models.raft import RAFT, RAFTConfig

    with torch.device("meta"):
        model = RAFT(config or RAFTConfig())
    return _state_dict_from_flax(tree, RAFT_TABLE, model)


def sky_state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``models.sky_segmentation.SkyUNet`` state_dict of a SkyUNet
    param tree."""
    from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet

    with torch.device("meta"):
        model = SkyUNet()
    return _state_dict_from_flax(tree, SKY_TABLE, model)


def yolo_state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``models.yolo.TinyYOLO`` state_dict of a TinyYOLO param tree."""
    from mav_detection_tpu_torch.models.yolo import TinyYOLO

    with torch.device("meta"):
        model = TinyYOLO()
    return _state_dict_from_flax(tree, YOLO_TABLE, model)


# ------------------------------------------ port weights back to Flax trees
def _flax_leaves(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    def np32(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy()

    w = sd[prefix + "weight"]
    out = {"bias": np32(sd[prefix + "bias"])}
    if w.ndim == 4:                            # OIHW -> HWIO
        out["kernel"] = np.ascontiguousarray(np32(w).transpose(2, 3, 1, 0))
    else:
        out["scale"] = np32(w)
    return out


def _unmap_tree(sd: Mapping[str, torch.Tensor], table: dict, prefix: str,
                used: set) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for flax_key, (port, children) in sorted(table.items()):
        p = prefix + (port + "." if port else "")
        if children is None:
            if p + "weight" not in sd:         # e.g. a block without ``down``
                continue
            tree[flax_key] = _flax_leaves(sd, p)
            used.update({p + "weight", p + "bias"})
        else:
            sub = _unmap_tree(sd, children, p, used)
            if sub:
                tree[flax_key] = sub
    return tree


def _flax_from_state_dict(sd: Mapping[str, torch.Tensor], table: dict) -> Dict[str, Any]:
    used: set = set()
    tree = _unmap_tree(sd, table, "", used)
    extra = sorted(set(sd) - used)
    if extra:
        raise ValueError(f"state_dict keys with no Flax counterpart: {extra}")
    return {"params": tree}


def flax_from_raft_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The Flax RAFT param tree (post-hoist layout) of a ``models.raft.RAFT``
    state_dict: the inverse of ``raft_state_dict_from_flax``."""
    return _flax_from_state_dict(sd, RAFT_TABLE)


def flax_from_sky_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The Flax SkyUNet param tree of a port state_dict."""
    return _flax_from_state_dict(sd, SKY_TABLE)


def flax_from_yolo_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The Flax TinyYOLO param tree of a port state_dict."""
    return _flax_from_state_dict(sd, YOLO_TABLE)

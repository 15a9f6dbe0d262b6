"""The port's Flax-checkpoint reader, its loaders and the weight conversion,
held to ``flax.serialization`` and the JAX package's ``pretrained``."""
import glob
import os
import struct
from pathlib import Path

import numpy as np
import pytest

import jax
from flax import serialization

from mav_detection_tpu.models import pretrained as j_pretrained

from mav_detection_tpu_torch import convert
from mav_detection_tpu_torch.models import checkpoint, pretrained
from mav_detection_tpu_torch.models.raft import RAFT
from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted(glob.glob(str(REPO / "checkpoints" / "*.msgpack")))


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


@pytest.fixture(autouse=True)
def _fresh_cache():
    pretrained.clear_cache()
    yield
    pretrained.clear_cache()


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_six_checkpoints_are_shipped():
    assert len(SHIPPED) == 6, SHIPPED


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: os.path.basename(p))
def test_reader_is_bit_equal_to_flax(path):
    """Same keys; every leaf equal in dtype, shape and bytes."""
    data = Path(path).read_bytes()
    ref = _leaves(serialization.msgpack_restore(data))
    got = _leaves(checkpoint.msgpack_restore(data))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k


def test_reader_decodes_every_type_flax_writes(rng):
    """ints of every width, floats, str/bin, nested maps and lists, complex,
    numpy scalars and arrays of several dtypes."""
    tree = {"a": {"i8": np.arange(6, dtype=np.int8).reshape(2, 3),
                  "f64": rng.standard_normal((3, 1)),
                  "f16": rng.standard_normal(4).astype(np.float16),
                  "scalar": np.float32(2.5), "bool": np.bool_(True)},
            "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32,
                     -33, -200, -40000, -(2**40)],
            "floats": [0.5, -1e300], "c": complex(1.5, -2.0), "s": "x" * 40,
            "b": b"\x00\x01" * 300, "none": None, "t": True, "f": False}
    data = serialization.msgpack_serialize(tree)
    ref, got = serialization.msgpack_restore(data), checkpoint.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for r, g in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
        assert type(g) is type(r) or np.asarray(g).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_bfloat16_leaf_comes_back_as_exact_float32():
    import jax.numpy as jnp

    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    got = checkpoint.msgpack_restore(serialization.msgpack_serialize({"x": np.asarray(x)}))
    assert got["x"].dtype == np.float32
    np.testing.assert_array_equal(got["x"], np.asarray(x, np.float32))


def test_chunked_leaf_raises(monkeypatch):
    """A leaf above Flax's chunk size is written as a chunked map; the
    reader refuses it."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize({"params": {"w": np.zeros(100, np.float32)}})
    with pytest.raises(ValueError, match="chunked"):
        checkpoint.msgpack_restore(data)


def test_truncated_and_unknown_data_raise():
    data = Path(SHIPPED[0]).read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.msgpack_restore(data[:1000])
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="ext type"):
        checkpoint.msgpack_restore(b"\xd4\x07\x00")
    with pytest.raises(ValueError, match="0xc1"):
        checkpoint.msgpack_restore(b"\xc1")
    assert checkpoint.msgpack_restore(struct.pack(">BH", 0xDC, 2) + b"\x01\x02") == [1, 2]


def test_load_msgpack_if_exists_matches_jax(tmp_path, rng):
    """None for a missing file on both sides; else the tree the JAX
    package's ``load_msgpack_if_exists`` restores into ``like``, leaf for
    leaf, and a ``like`` of other keys or shapes raises."""
    from mav_detection_tpu.models import checkpoint as j_checkpoint

    tree = {"params": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                                "bias": rng.standard_normal(4).astype(np.float32)},
                       "scale": np.float32(0.5) * np.ones((2,), np.float32)}}
    like = jax.tree_util.tree_map(np.zeros_like, tree)
    missing = str(tmp_path / "missing.msgpack")
    assert checkpoint.load_msgpack_if_exists(missing, like) is None
    assert j_checkpoint.load_msgpack_if_exists(missing, like) is None
    path = str(tmp_path / "tree.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))
    got = checkpoint.load_msgpack_if_exists(path, like)
    want = j_checkpoint.load_msgpack_if_exists(path, like)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="keys"):
        checkpoint.load_msgpack_if_exists(path, {"params": {}})
    bad = jax.tree_util.tree_map(lambda a: np.zeros((7,), np.float32), like)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_msgpack_if_exists(path, bad)


def test_migration_moves_exactly_the_mask_head():
    """``Conv_6`` and ``mask_head`` leave refine/update for mask_hidden /
    mask_head; nothing else moves; the JAX migration does the same."""
    path = str(REPO / "checkpoints" / "raft.msgpack")
    raw = _leaves(checkpoint.load_msgpack(path))
    got = _leaves(checkpoint.load_msgpack(path, migrate=pretrained._migrate_raft_state))
    ref = _leaves(j_pretrained._migrate_raft_state(
        serialization.msgpack_restore(Path(path).read_bytes())))
    assert sorted(got) == sorted(ref)
    moved = {k for k in raw if k not in got}
    assert moved == {f"params/refine/update/{m}/{p}" for m in ("Conv_6", "mask_head")
                     for p in ("kernel", "bias")}
    for m_old, m_new in (("Conv_6", "mask_hidden"), ("mask_head", "mask_head")):
        for p in ("kernel", "bias"):
            np.testing.assert_array_equal(got[f"params/{m_new}/{p}"],
                                          raw[f"params/refine/update/{m_old}/{p}"])
    # a post-hoist state passes through unchanged
    again = _leaves(pretrained._migrate_raft_state(
        checkpoint.load_msgpack(path, migrate=pretrained._migrate_raft_state)))
    assert sorted(again) == sorted(got)


def test_checkpoint_root_honours_env(tmp_path, monkeypatch):
    monkeypatch.delenv("MAV_CHECKPOINT_PATH", raising=False)
    assert pretrained.checkpoint_root() == str(REPO / "checkpoints")
    assert pretrained.checkpoint_path("raft") == j_pretrained.checkpoint_path("raft")
    assert pretrained.has_checkpoint("raft") and pretrained.has_checkpoint("sky")
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    assert pretrained.checkpoint_path("sky") == str(tmp_path / "sky.msgpack")
    assert not pretrained.has_checkpoint("sky")
    assert pretrained.load_raft_params() is None
    assert pretrained.load_sky_params() is None
    assert pretrained.load_raft("cpu") is None and pretrained.load_sky("cpu") is None


@pytest.mark.parametrize("mode", [None, "APPEARANCE_RGB", "FLOW_UV", "FLOW_RADIAL",
                                  "FLOW_FOE_YOLO", "FLOW_FOE_CLUSTERING"])
def test_yolo_names_resolve_as_the_reference(mode, tmp_path, monkeypatch):
    assert pretrained.yolo_checkpoint_name(mode) == j_pretrained.yolo_checkpoint_name(mode)
    assert pretrained.resolve_yolo_checkpoint(mode) == j_pretrained.resolve_yolo_checkpoint(mode)
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    assert pretrained.resolve_yolo_checkpoint(mode) == j_pretrained.resolve_yolo_checkpoint(mode)


def test_loaders_cache_per_process_and_per_device():
    a = pretrained.load_raft_params()
    assert pretrained.load_raft_params() is a
    m = pretrained.load_raft("cpu")
    assert pretrained.load_raft("cpu") is m
    assert m.mask_head.weight.data_ptr() == a["mask_head.weight"].data_ptr()
    pretrained.clear_cache()
    assert pretrained.load_raft_params() is not a


@pytest.mark.parametrize("name,convert_fn,model_cls", [
    ("raft", convert.raft_state_dict_from_flax, RAFT),
    ("sky", convert.sky_state_dict_from_flax, SkyUNet)])
def test_conversion_uses_every_tensor(name, convert_fn, model_cls):
    """Every Flax leaf lands in the model's state_dict and every entry of it
    is filled: conv kernels HWIO -> OIHW, GroupNorm scale -> weight."""
    tree = checkpoint.load_msgpack(
        str(REPO / "checkpoints" / f"{name}.msgpack"),
        migrate=pretrained._migrate_raft_state if name == "raft" else None)
    flax_leaves = _leaves(tree)
    sd = convert_fn(tree)
    model = model_cls()
    assert sorted(sd) == sorted(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(v.size for v in flax_leaves.values())
    model.load_state_dict(sd)            # strict: nothing missing, nothing extra
    # spot-check the layouts against the Flax leaves
    first_conv = "fnet/Conv_0" if name == "raft" else "ConvBlock_0/Conv_0"
    port = "fnet.stem" if name == "raft" else "down1.conv1"
    np.testing.assert_array_equal(
        sd[f"{port}.weight"].numpy(),
        flax_leaves[f"params/{first_conv}/kernel"].transpose(3, 2, 0, 1))
    norm = "fnet/GroupNorm_0" if name == "raft" else "ConvBlock_0/GroupNorm_0"
    port_norm = "fnet.stem_norm" if name == "raft" else "down1.norm1"
    np.testing.assert_array_equal(sd[f"{port_norm}.weight"].numpy(),
                                  flax_leaves[f"params/{norm}/scale"])


def test_conversion_refuses_leftovers_on_either_side():
    path = str(REPO / "checkpoints" / "raft.msgpack")
    with pytest.raises(ValueError, match="no counterpart"):
        # the pre-hoist layout: refine/update/Conv_6 has no port module
        convert.raft_state_dict_from_flax(checkpoint.load_msgpack(path))
    tree = checkpoint.load_msgpack(path, migrate=pretrained._migrate_raft_state)
    del tree["params"]["mask_head"]
    with pytest.raises(ValueError, match="missing"):
        convert.raft_state_dict_from_flax(tree)
    sky = checkpoint.load_msgpack(str(REPO / "checkpoints" / "sky.msgpack"))
    sky["params"]["Conv_0"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unexpected Flax leaf"):
        convert.sky_state_dict_from_flax(sky)

"""Reader and writer of Flax msgpack checkpoints
(``mav_detection_tpu.models.checkpoint``).

``flax.serialization.to_bytes`` writes a msgpack map of nested string-keyed
maps whose leaves are numpy arrays packed as msgpack extension types. This
module decodes and encodes that subset in plain Python, so neither ``flax``
nor ``msgpack`` is needed:

* maps, arrays, str / bin, nil and booleans, ints and floats;
* ext type 1 (ndarray): the payload is itself msgpack, the tuple
  ``(shape, dtype name, C-order bytes)``;
* ext type 2 (complex): the payload is the tuple ``(real, imag)``;
* ext type 3 (numpy scalar): an ndarray payload of shape ``()``.

Arrays above 1 GiB are split by Flax into a ``__msgpack_chunked_array__``
map; no shipped checkpoint has one, and such a leaf raises rather than being
guessed. ``bfloat16`` leaves (numpy has no such type) come back as float32,
which holds every bfloat16 value exactly.

``msgpack_serialize`` writes the bytes ``flax.serialization.msgpack_serialize``
writes for the same tree: map keys sorted (Flax copies the tree through
``jax.tree_util``, which sorts dict keys), the smallest msgpack encoding of
every length and integer, arrays as ext type 1. ``save_msgpack`` puts them in
a file, which the JAX package's ``load_msgpack`` reads.

The reference's orbax ``save`` / ``load`` / ``load_if_exists`` write an orbax
directory tree; the port has no orbax, and its three functions of those names
write and read one msgpack file in the layout above instead (a divergence by
design).
"""
from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A cursor over one msgpack buffer. ``raw`` keeps str payloads as bytes
    (Flax decodes the ndarray tuple that way)."""

    def __init__(self, data: bytes, raw: bool = False) -> None:
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:                         # positive fixint
            return b
        if b >= 0xE0:                         # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}          # bin
        if b in lengths:
            return self.take(self.unpack(lengths[b]))
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}          # ext
        if b in lengths:
            n = self.unpack(lengths[b])
            return self.ext(n)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:                 # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}          # str
        if b in lengths:
            return self.str(self.unpack(lengths[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by Flax")

    def str(self, n: int) -> Any:
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one Flax writes")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload, raw=True).value()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape, order="C")


def _refuse_chunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError(
                f"checkpoint leaf {path or '<root>'} is a chunked array (over "
                "1 GiB); the port's reader does not join chunks")
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for ``data``:
    nested dicts with numpy array leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    _refuse_chunked(tree)
    return tree


def load_msgpack(path: str, migrate: Optional[Callable[[Dict], Dict]] = None
                 ) -> Dict[str, Any]:
    """The raw state of a Flax msgpack checkpoint; ``migrate``, if given,
    receives it and may rewrite legacy key layouts."""
    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    return migrate(state) if migrate is not None else state


def load_msgpack_if_exists(path: str, like: Any) -> Optional[Dict[str, Any]]:
    """``load_msgpack``'s state of ``path`` checked against ``like`` (a tree
    of the same keys and leaf shapes; a mismatch raises) as ``load`` does,
    or None where the file does not exist."""
    if not os.path.exists(path):
        return None
    state = load_msgpack(path)
    _check_like(state, like)
    return state


# ------------------------------------------------------------------ writer
MAX_CHUNK_BYTES = 2 ** 30    # Flax splits larger arrays into chunks


def _length(out: List[bytes], n: int, fix: Optional[int], fix_max: int,
            codes: tuple) -> None:
    """A msgpack length header: the fix form below ``fix_max``, then the 8-,
    16- and 32-bit forms (``codes``; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out.append(struct.pack(fmt, code, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                              (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if v >= lo:
                out.append(struct.pack(fmt, code, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    else:
        _length(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _array_payload(arr: Any) -> bytes:
    """msgpack of ``(shape, dtype name, C-order bytes)``: a torch bfloat16
    tensor is written under the name ``bfloat16`` with its raw bits."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, data = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    else:
        a = np.asarray(arr)
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured arrays cannot be serialised")
        shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    if len(data) > MAX_CHUNK_BYTES:
        raise ValueError(f"array of {len(data)} bytes: Flax would chunk it, "
                         "the port's writer does not")
    out: List[bytes] = []
    _pack(out, [list(shape), name, data])
    return b"".join(out)


def _pack(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, (torch.Tensor, np.ndarray)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(struct.pack(">Bd", 0xCB, v))
    elif isinstance(v, complex):
        inner: List[bytes] = []
        _pack(inner, [v.real, v.imag])
        _pack_ext(out, EXT_COMPLEX, b"".join(inner))
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _length(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(v, (bytes, bytearray)):
        _length(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _length(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        keys = sorted(v)
        _length(out, len(keys), 0x80, 16, (None, 0xDE, 0xDF))
        for k in keys:
            _pack(out, k)
            _pack(out, v[k])
    else:
        raise TypeError(f"cannot serialise {type(v).__name__} to msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for ``tree``
    (nested dicts with numpy-array or tensor leaves)."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


def save_msgpack(path: str, params: Any) -> str:
    """Write ``params`` as a Flax msgpack checkpoint (the reference's
    ``save_msgpack``, which ``load_msgpack`` of either package reads)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack_serialize(params)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _check_like(tree: Any, like: Any, path: str = "") -> None:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint tree at {path or '<root>'} has keys "
                             f"{sorted(tree) if isinstance(tree, dict) else tree!r}, "
                             f"expected {sorted(like)}")
        for k in like:
            _check_like(tree[k], like[k], f"{path}/{k}")
    elif tuple(np.shape(tree)) != tuple(np.shape(like)):
        raise ValueError(f"checkpoint leaf {path}: shape {np.shape(tree)}, "
                         f"expected {np.shape(like)}")


def save(path: str, params: Any, force: bool = True) -> str:
    """The reference's orbax ``save``, over one msgpack file: ``force=False``
    refuses to overwrite."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"{path} exists (pass force=True to overwrite)")
    return save_msgpack(path, params)


def load(path: str, like: Optional[Any] = None) -> Any:
    """The tree ``save`` wrote; with ``like`` (a tree of the same keys and
    leaf shapes) a mismatch raises."""
    with open(os.path.abspath(path), "rb") as f:
        tree = msgpack_restore(f.read())
    if like is not None:
        _check_like(tree, like)
    return tree


def load_if_exists(path: str, like: Optional[Any] = None) -> Optional[Any]:
    if not os.path.exists(path):
        return None
    return load(path, like)

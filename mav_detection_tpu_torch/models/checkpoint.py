"""Reader of the shipped Flax msgpack checkpoints
(``mav_detection_tpu.models.checkpoint``, the msgpack tier).

``flax.serialization.to_bytes`` writes a msgpack map of nested string-keyed
maps whose leaves are numpy arrays packed as msgpack extension types. This
module decodes that subset in plain Python, so neither ``flax`` nor
``msgpack`` is needed:

* maps, arrays, str / bin, nil and booleans, ints and floats;
* ext type 1 (ndarray): the payload is itself msgpack, the tuple
  ``(shape, dtype name, C-order bytes)``;
* ext type 2 (complex): the payload is the tuple ``(real, imag)``;
* ext type 3 (numpy scalar): an ndarray payload of shape ``()``.

Arrays above 1 GiB are split by Flax into a ``__msgpack_chunked_array__``
map; no shipped checkpoint has one, and such a leaf raises rather than being
guessed. ``bfloat16`` leaves (numpy has no such type) come back as float32,
which holds every bfloat16 value exactly.

The orbax ``save`` / ``load`` and ``save_msgpack`` of the reference are
training-side and not ported.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Optional

import numpy as np

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

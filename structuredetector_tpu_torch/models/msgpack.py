"""Read and write the msgpack files of the JAX package's checkpoints,
without flax or the `msgpack` package.

`flax.serialization.msgpack_serialize` writes a nested map of string keys
whose leaves are numpy arrays, each packed as msgpack ext type 1 holding
a msgpack array `[shape, dtype name, raw C-order bytes]` (ext type 3 is a
numpy scalar in the same form). Arrays above 2**30 bytes are split into a
map with a `__msgpack_chunked_array__` key. This module reads that
subset of msgpack (nil, bool, int, float, str, bin, array, map, ext) and
writes the same layout for a tree of numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # type byte -> (length format, reader)
            0xC4: (">B", self._bin), 0xC5: (">H", self._bin), 0xC6: (">I", self._bin),
            0xD9: (">B", self._str), 0xDA: (">H", self._str), 0xDB: (">I", self._str),
            0xDC: (">H", self._array), 0xDD: (">I", self._array),
            0xDE: (">H", self._map), 0xDF: (">I", self._map),
        }
        if b in sized:
            fmt, reader = sized[b]
            return reader(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self._ext(self.unpack(ext[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        if dtype == "bfloat16":  # numpy has no such dtype; SDNet keeps f32 weights
            raise ValueError("bfloat16 arrays are not supported; save float32 weights")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """Decode one msgpack object (flax's layout) into dicts, lists,
    Python scalars and numpy arrays."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)


# ----------------------------------------------------------------------
# writing


def _head(out: bytearray, n: int, fix: Tuple[int, int], wide: Tuple[int, ...]) -> None:
    """A length header: the fix form (base, limit) when n fits, else the
    8/16/32-bit forms whose type bytes `wide` lists (0 = form absent)."""
    base, limit = fix
    if n < limit:
        out.append(base | n)
        return
    for code, fmt, top in zip(wide, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
            return
        forms = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if obj > 0
                 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))
        for code, fmt in forms:  # the smallest form that holds it
            bits = 8 * struct.calcsize(fmt)
            if (obj < 1 << bits) if obj > 0 else (obj >= -(1 << (bits - 1))):
                out.append(code)
                out += struct.pack(fmt, obj)
                return
        raise ValueError(f"integer {obj} does not fit in 64 bits")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _head(out, len(obj), (0, 0), (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), (0x90, 16), (0, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _head(out, len(obj), (0x80, 16), (0, 0xDE, 0xDF))
        for key in sorted(obj):  # flax's tree_map sorts the keys too
            _pack(out, key)
            _pack(out, obj[key])
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack(payload, [list(obj.shape), obj.dtype.name, obj.tobytes("C")])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _head(out, len(payload), (0, 0), (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def dumps(tree: Dict[str, Any]) -> bytes:
    """Encode a nested dict of numpy arrays in flax's layout, byte for
    byte what `flax.serialization.msgpack_serialize` writes for it
    (arrays up to 2**30 bytes, which is every SDNet weight)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)

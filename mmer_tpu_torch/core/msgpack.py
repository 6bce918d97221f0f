"""The msgpack subset that ``flax.serialization.to_bytes`` writes for a
parameter tree, in pure Python (the port depends on no ``msgpack`` package).

A flax checkpoint is one msgpack map: nested maps with str keys whose leaves
are arrays, each an ext value of code 1 whose payload is itself msgpack,
``[shape, dtype name, raw C-order bytes]``.  :func:`packb` writes exactly the
bytes ``msgpack.packb(tree, use_bin_type=True)`` with flax's ext hook writes
(smallest int, str, bin, map, array and ext forms; floats as float 64; map
keys in the tree's order); :func:`unpackb` reads every standard msgpack type
back, arrays as numpy arrays.  Refused, by name: any other ext code (flax's
complex numbers and numpy scalars), flax's chunked form of arrays over 2**30
bytes, and bfloat16 arrays (a fusion checkpoint is float32).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_ARRAY_BYTES = 2 ** 30      # flax chunks arrays above this (serialization.py)


# -- writing ---------------------------------------------------------------------

def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if x >= low:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} does not fit msgpack's int64")


def _pack_len(n: int, fix: Tuple[int, int] | None, codes, out: bytearray) -> None:
    """A length header: the fix form (base, limit) when it fits, else the
    8/16/32-bit forms in ``codes`` (None where a form does not exist)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, (0xC7, 0xC8, 0xC9), out)
    out.append(code)
    out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(x: Any, out: bytearray) -> None:
    if isinstance(x, np.generic):
        raise TypeError(f"a numpy scalar ({x.dtype}): flax writes those as "
                        "ext 3, which is not written here")
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(int(x), out)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _pack_len(len(data), None, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(x, dict):
        _pack_len(len(x), (0x80, 16), (None, 0xDE, 0xDF), out)
        for key, value in x.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), (0x90, 16), (None, 0xDC, 0xDD), out)
        for value in x:
            _pack(value, out)
    elif isinstance(x, np.ndarray):
        if x.nbytes > MAX_ARRAY_BYTES:
            raise ValueError(f"an array of {x.nbytes} bytes needs flax's "
                             "chunked-array form, which is not written here")
        _pack_ext(EXT_NDARRAY, _ndarray_payload(x), out)
    else:
        raise TypeError(f"cannot serialize a {type(x).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` → msgpack bytes (see the module docstring)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- reading ---------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("a bfloat16 array: the port reads float32 fusion "
                         "checkpoints")
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _read(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        return r.unpack(scalars[b])
    lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    if b in lengths:
        return bytes(r.take(r.unpack(lengths[b]))).decode("utf-8")
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
    if b in lengths:
        return bytes(r.take(r.unpack(lengths[b])))
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    if b in fixed or b in lengths:
        n = fixed[b] if b in fixed else r.unpack(lengths[b])
        code = r.unpack(">b")
        payload = bytes(r.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext code {code}: only flax's ndarray "
                             f"(code {EXT_NDARRAY}) is read")
        return _ndarray_from_payload(payload)
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    if CHUNKED_KEY in out:
        raise ValueError("flax's chunked-array form (an array over 2**30 "
                         "bytes) is not read")
    return out


def unpackb(data: bytes) -> Any:
    """msgpack bytes → Python objects; ext-1 arrays become numpy arrays."""
    r = _Reader(bytes(data))
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return obj

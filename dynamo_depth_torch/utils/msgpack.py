"""The subset of msgpack that ``flax.serialization`` writes, in the standard
library and numpy: the port's reader (and writer) of the JAX package's
``.msgpack`` checkpoint files (``dynamo_depth_tpu/training/checkpoint.py``).

:func:`restore` is ``flax.serialization.msgpack_restore``: maps (string
keys), strings, binary, arrays (as lists), integers of every width, floats,
nil and booleans, and flax's two array extensions, ext type 1 (an ndarray:
a msgpack ``[shape, dtype name, raw bytes]``, C order, little-endian) and
ext type 3 (a numpy scalar in the same form). It refuses ext type 2
(flax's ``native_complex``), any other ext code, arrays of a dtype outside
the plain numeric ones (``bfloat16`` has no numpy name: the JAX package
saves its parameters, statistics and Adam state in float32 and int32 even
under ``compute_dtype="bfloat16"``), and flax's chunked arrays
(``__msgpack_chunked_array__``, written only for leaves above 2**30 bytes).

:func:`packb` writes the same subset with the encoding msgpack's own packer
chooses (the smallest integer, string and container forms, floats as
float64) and map keys in sorted order (flax's ``tree_map`` sorts them), so
a tree of dicts, lists, strings, numbers and numpy arrays gives
the bytes ``flax.serialization.msgpack_serialize`` gives.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = "__msgpack_chunked_array__"
DTYPES = frozenset(
    ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64"])


class MsgpackError(ValueError):
    """Bytes outside the subset this module reads or writes."""


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def obj(self):
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack((">B", ">H", ">I")[t - 0xC4]))
        if t in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack((">B", ">H", ">I")[t - 0xD9]))
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[t - 0xC7])
            return _ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= t <= 0xD8:
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (t - 0xD4)))
        raise MsgpackError(f"msgpack type byte 0x{t:02x} is not used by flax.serialization")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(f"map key {key!r}: flax trees have string keys")
            out[key] = self.obj()
        return out


def _unpackb(data: bytes, raw: bool = False):
    reader = _Reader(data, raw)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = _unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in DTYPES:
        raise MsgpackError(f"array of dtype {name!r}: only {sorted(DTYPES)} are read (bfloat16 has no numpy dtype; "
                           "the JAX package saves float32)")
    return np.frombuffer(buf, dtype=np.dtype(name).newbyteorder("<")).astype(name).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        raise MsgpackError("ext type 2 (flax's native_complex) is not read: no leaf of this model is complex")
    raise MsgpackError(f"unknown msgpack ext type {code}")


def _refuse_chunks(tree):
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise MsgpackError(f"chunked array ({CHUNKED_KEY}) is not read: flax writes one only for a leaf above "
                               "2**30 bytes, and no leaf of this model comes near that")
        for v in tree.values():
            _refuse_chunks(v)
    return tree


def restore(data: bytes):
    """``flax.serialization.msgpack_restore(data)``: the tree of dicts,
    lists and numpy leaves. Raises :class:`MsgpackError` on what this
    module does not read."""
    return _refuse_chunks(_unpackb(bytes(data)))


def _uint(n: int, forms) -> bytes:
    for limit, head, fmt in forms:
        if n <= limit:
            return struct.pack(">B" + fmt, head, n)
    raise MsgpackError(f"length {n} too large for msgpack")


def _length(n: int, fix: int, fix_max: int, heads) -> bytes:
    if n <= fix_max:
        return struct.pack(">B", fix | n)
    return _uint(n, [(limit, h, fmt) for limit, h, fmt in zip((0xFF, 0xFFFF, 0xFFFFFFFF), heads, ("B", "H", "I"))
                     if h is not None])


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n > 0:
        forms = ((0xFF, 0xCC, "B"), (0xFFFF, 0xCD, "H"), (0xFFFFFFFF, 0xCE, "I"), (0xFFFFFFFFFFFFFFFF, 0xCF, "Q"))
    else:
        forms = ((-0x80, 0xD0, "b"), (-0x8000, 0xD1, "h"), (-0x80000000, 0xD2, "i"), (-0x8000000000000000, 0xD3, "q"))
    for limit, head, fmt in forms:
        if (n <= limit) if n > 0 else (n >= limit):
            return struct.pack(">B" + fmt, head, n)
    raise MsgpackError(f"integer {n} out of msgpack's range")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return struct.pack(">Bb", fixed[len(data)], code) + data
    return _uint(len(data), ((0xFF, 0xC7, "B"), (0xFFFF, 0xC8, "H"), (0xFFFFFFFF, 0xC9, "I"))) + \
        struct.pack(">b", code) + data


def _pack_array_leaf(a: np.ndarray) -> bytes:
    if a.dtype.name not in DTYPES:
        raise MsgpackError(f"array of dtype {a.dtype.name!r} is not written")
    return packb([list(a.shape), a.dtype.name, a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes("C")])


def packb(obj) -> bytes:
    """Encode ``obj`` (dicts with string keys, lists, tuples, str, bytes,
    bool, None, int, float, numpy arrays and scalars) as flax does."""
    out = []

    def enc(x):
        if x is None:
            out.append(b"\xc0")
        elif isinstance(x, bool):
            out.append(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int):
            out.append(_pack_int(x))
        elif isinstance(x, float):
            out.append(struct.pack(">Bd", 0xCB, x))
        elif isinstance(x, str):
            b = x.encode("utf-8")
            out.append(_length(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            b = bytes(x)
            out.append(_uint(len(b), ((0xFF, 0xC4, "B"), (0xFFFF, 0xC5, "H"), (0xFFFFFFFF, 0xC6, "I"))) + b)
        elif isinstance(x, dict):
            out.append(_length(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
            for k, v in sorted(x.items()):
                if not isinstance(k, str):
                    raise MsgpackError(f"map key {k!r}: flax trees have string keys")
                enc(k)
                enc(v)
        elif isinstance(x, (list, tuple)):
            out.append(_length(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
            for v in x:
                enc(v)
        elif isinstance(x, np.ndarray):
            out.append(_pack_ext(EXT_NDARRAY, _pack_array_leaf(x)))
        elif isinstance(x, np.generic):
            out.append(_pack_ext(EXT_NPSCALAR, _pack_array_leaf(np.asarray(x))))
        else:
            raise MsgpackError(f"{type(x).__name__} is not written (complex numbers and objects are refused)")

    enc(obj)
    return b"".join(out)

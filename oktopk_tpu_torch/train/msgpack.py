"""flax's msgpack checkpoint format, written out in numpy.

The JAX package serialises its train state with
``flax.serialization.to_bytes`` / ``msgpack_restore``; neither ``flax``
nor ``msgpack`` is a dependency of the port, so this module writes the
same bytes and reads them back:

- maps with string keys, ints (msgpack's smallest form), floats (float
  64), str, bytes, bool and nil; a list or tuple as flax's
  ``to_state_dict`` writes it, a map keyed "0", "1", ...;
- ``np.ndarray`` as ext type 1: the msgpack array ``(shape, dtype name,
  raw C-order bytes)``; a numpy scalar as ext type 3, the same payload of
  its 0-d array;
- flax's chunking: an array of more than ``MAX_CHUNK_SIZE`` bytes held
  in a map (or at the root) becomes ``{"__msgpack_chunked_array__":
  True, "shape": {"0": d0, ...}, "chunks": {"0": c0, ...}}``, the
  flattened array cut into pieces of ``MAX_CHUNK_SIZE // itemsize``
  elements (``flax/serialization.py::_chunk``).

Maps are written in their insertion order, so a tree built in flax's
order (``to_state_dict``: a dataclass's fields in declaration order, a
dict's keys as ``jax.device_get`` leaves them, sorted) encodes to
``flax.serialization.to_bytes``' bytes.

``encode`` returns the encoding as a list of buffers (headers and
``memoryview``s of the arrays' own memory), so a multi-gigabyte state is
written and digested without a second copy; ``decode`` reads from any
buffer and returns arrays that are views of it (``np.frombuffer``), but
for chunked arrays, which are joined.
"""

from __future__ import annotations

import struct
from typing import Any, List, Union

import numpy as np

# flax/serialization.py: msgpack's per-object limit is 2**31 - 1 bytes
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

Buffer = Union[bytes, bytearray, memoryview]


# ---------------------------------------------------------------------------
# encoding

def _int(v: int) -> bytes:
    if v >= 0:
        if v <= 0x7F:
            return bytes((v,))
        if v <= 0xFF:
            return b"\xcc" + struct.pack(">B", v)
        if v <= 0xFFFF:
            return b"\xcd" + struct.pack(">H", v)
        if v <= 0xFFFFFFFF:
            return b"\xce" + struct.pack(">I", v)
        return b"\xcf" + struct.pack(">Q", v)
    if v >= -32:
        return struct.pack(">b", v)
    if v >= -0x80:
        return b"\xd0" + struct.pack(">b", v)
    if v >= -0x8000:
        return b"\xd1" + struct.pack(">h", v)
    if v >= -0x80000000:
        return b"\xd2" + struct.pack(">i", v)
    return b"\xd3" + struct.pack(">q", v)


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str/bin/array/map of length ``n``: the fix form below
    ``fix_max`` (when the type has one), else the 8/16/32-bit forms of
    ``codes`` (None where the type lacks that form)."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        return bytes((c8, n))
    if n <= 0xFFFF:
        return bytes((c16,)) + struct.pack(">H", n)
    return bytes((c32,)) + struct.pack(">I", n)


def _str_header(n: int) -> bytes:
    return _len_header(n, 0xA0, 32, (0xD9, 0xDA, 0xDB))


def _bin_header(n: int) -> bytes:
    return _len_header(n, None, 0, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _len_header(n, 0x90, 16, (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _len_header(n, 0x80, 16, (None, 0xDE, 0xDF))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    if n <= 0xFF:
        return bytes((0xC7, n, code))
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">H", n) + bytes((code,))
    return b"\xc9" + struct.pack(">I", n) + bytes((code,))


def _str(s: str) -> List[Buffer]:
    b = s.encode("utf-8")
    return [_str_header(len(b)), b]


def _ndarray(arr: np.ndarray, code: int) -> List[Buffer]:
    """ext ``code`` of flax's ``_ndarray_to_bytes``: packb((shape, dtype
    name, bytes)), the bytes being the array's own memory."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    if not arr.flags.c_contiguous:      # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    data = memoryview(arr.reshape(-1).view(np.uint8))
    head = [_array_header(3), _array_header(arr.ndim)]
    head += [_int(int(d)) for d in arr.shape]
    head += _str(arr.dtype.name)
    head.append(_bin_header(data.nbytes))
    head = b"".join(head)
    return [_ext_header(len(head) + data.nbytes, code), head, data]


def _chunk(arr: np.ndarray) -> dict:
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + chunksize] for i, s in
                       enumerate(range(0, flat.size, chunksize))}}


def _oversized(v) -> bool:
    return (isinstance(v, np.ndarray)
            and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE)


def _encode(obj, out: List[Buffer]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.extend(_str(obj))
    elif type(obj) in (bytes, bytearray):
        out += [_bin_header(len(obj)), bytes(obj)]
    elif type(obj) is dict:
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            out.extend(_str(k))
            _encode(_chunk(v) if _oversized(v) else v, out)
    elif type(obj) in (list, tuple):
        _encode({str(i): v for i, v in enumerate(obj)}, out)
    elif isinstance(obj, np.ndarray):
        out.extend(_ndarray(obj, EXT_NDARRAY))
    elif isinstance(obj, np.generic):
        out.extend(_ndarray(np.asarray(obj), EXT_NPSCALAR))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r}")


def encode(tree: Any) -> List[Buffer]:
    """The msgpack encoding of ``tree`` as a list of buffers (join them,
    or write them in order)."""
    out: List[Buffer] = []
    _encode(_chunk(tree) if _oversized(tree) else tree, out)
    return out


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    return b"".join(encode(tree))


# ---------------------------------------------------------------------------
# decoding

class _Reader:
    def __init__(self, buf: Buffer):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}


def _read(r: _Reader, raw: bool = False):
    """One object; ``raw`` keeps str as bytes and bin as a view of the
    buffer (the ndarray payload is read so)."""
    c = r.take(1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _read_map(r, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return [_read(r, raw) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return _text(r.take(c & 0x1F), raw)
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _FIXED:
        v = r.unpack(_FIXED[c])
        return float(v) if c in (0xCA, 0xCB) else v
    if c in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])
        return r.take(n) if raw else bytes(r.take(n))
    if c in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c])
        return _text(r.take(n), raw)
    if c in (0xDC, 0xDD):
        n = r.unpack(">H" if c == 0xDC else ">I")
        return [_read(r, raw) for _ in range(n)]
    if c in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if c == 0xDE else ">I"))
    if 0xD4 <= c <= 0xD8:
        n = 1 << (c - 0xD4)
    elif c in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
    else:
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")
    code = r.unpack(">b")
    return _ext(code, r.take(n))


def _text(mv: memoryview, raw: bool):
    return bytes(mv) if raw else str(mv, "utf-8")


def _read_map(r: _Reader, n: int) -> dict:
    d = {}
    for _ in range(n):
        k = _read(r)
        d[k] = _read(r)
    if CHUNKED in d:
        return _unchunk(d)
    return d


def _ext(code: int, data: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    inner = _Reader(data)
    shape, dtype, buf = _read(inner, raw=True)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(
        tuple(shape))
    return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def decode(buf: Buffer) -> Any:
    """``flax.serialization.msgpack_restore``: the tree encoded in
    ``buf``. Arrays are views of ``buf`` (writable when ``buf`` is a
    ``bytearray``); bin values are ``memoryview``s of it."""
    r = _Reader(buf)
    out = _read(r)
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} trailing bytes after the "
                         "msgpack object")
    return out

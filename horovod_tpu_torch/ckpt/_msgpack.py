"""flax's msgpack checkpoint bytes, without flax.

The port of the subset of flax ``serialization.py`` that a checkpoint
writes and reads (``msgpack_serialize``, ``msgpack_restore``):

* a tree of dicts (string keys) and lists, with ints, floats, strings,
  bools, None and numpy leaves;
* a numpy array as msgpack ext type 1 holding the msgpack array
  ``(shape, dtype name, C-order bytes)``; a numpy scalar as ext type 3
  in the same form (it comes back as a scalar);
* an array above ``MAX_CHUNK_SIZE`` bytes (2**30) as flax's
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
  {...}}`` dict of flat chunks.

``serialize`` first rebuilds every dict with its keys sorted, as flax's
``msgpack_serialize`` does (its ``jax.tree_util.tree_map`` copy sorts
them), so the bytes equal flax's and so do their CRC32s.
``serialize(..., sort_keys=False)`` keeps insertion order (flax's
``to_bytes``).

The codec is pure Python: the msgpack types a checkpoint holds and
nothing more. An array's bytes are joined once, without a per-element
pass.
"""

import struct

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# -- the tree transforms flax applies around msgpack ------------------------

def _prepare(tree, sort_keys):
    """Copy the containers (dicts sorted when ``sort_keys``), and chunk
    every oversized array that is a dict's value or the root, as flax's
    ``_chunk_array_leaves_in_place`` does."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else list(tree)
        out = {}
        for k in keys:
            v = _prepare(tree[k], sort_keys)
            if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_SIZE:
                v = _chunk(v)
            out[k] = v
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(v, sort_keys) for v in tree)
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _chunk(arr):
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _unchunk_in_place(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_in_place(v)
    return d


def _unchunk(d):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _check_dtype(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")


def _array_from(triple):
    shape, dtype, buf = triple
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    return np.frombuffer(buf, dtype=np.dtype(dtype), count=-1,
                         offset=0).reshape(shape, order="C")


# -- the codec ------------------------------------------------------------------

def _pack_int(n, out):
    if 0 <= n < 128:
        out.append(bytes((n,)))
    elif -32 <= n < 0:
        out.append(bytes((n & 0xFF,)))
    elif n >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"),
                                 (1 << 64, 0xCF, ">Q")):
            if n < limit:
                out.append(bytes((code,)) + struct.pack(fmt, n))
                return
        raise OverflowError("Integer value out of range")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"),
                                 (1 << 63, 0xD3, ">q")):
            if n >= -limit:
                out.append(bytes((code,)) + struct.pack(fmt, n))
                return
        raise OverflowError("Integer value out of range")


def _pack_len(n, out, fix, fix_max, codes):
    """A length header: the fix form below ``fix_max``, else the 8-,
    16- or 32-bit form of ``codes`` (None where the type has none)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"object of {n} elements or bytes is too large")


def _pack_array(code, arr, out):
    """An array as an ext of its ``(shape, dtype name, bytes)``: the
    bytes as one buffer, copied once, when the parts are joined."""
    _check_dtype(arr)
    head = []
    _pack(list(arr.shape), head)
    _pack(arr.dtype.name, head)
    arr = np.ascontiguousarray(arr)
    data = memoryview(arr.reshape(-1)).cast("B") if arr.size else b""
    _pack_len(len(data), head, None, 0, (0xC4, 0xC5, 0xC6))
    inner = [bytes((0x93,))] + head
    n = sum(len(p) for p in inner) + len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes((fixed[n],)))
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.extend(inner)
    out.append(data)


def _pack(x, out):
    """msgpack's ``packb(x, strict_types=True)`` as a list of byte parts:
    under strict types a tuple is not an array (flax's trees hold
    none)."""
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        b = x.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif t in (bytes, bytearray, memoryview):
        b = bytes(x)
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out.append(b)
    elif t is list:
        _pack_len(len(x), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(x), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _pack_array(_EXT_NDARRAY, x, out)
    elif isinstance(x, np.generic):
        _pack_array(_EXT_NPSCALAR, np.asarray(x), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


class _Reader:
    def __init__(self, data, raw):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def seq(self, n):
        return [self.read() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n):
        code = self.num(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        arr = _array_from(_Reader(data, raw=True).read())
        return arr if code == _EXT_NDARRAY else arr[()]

    def read(self):
        c = self.num(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c & 0xF0 == 0x80:
            return self.map(c & 0x0F)
        if c & 0xF0 == 0x90:
            return self.seq(c & 0x0F)
        if c & 0xE0 == 0xA0:
            return self.text(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.num(ints[c])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= c <= 0xC6:
            return bytes(self.take(self.num(sizes[c - 0xC4])))
        if 0xD9 <= c <= 0xDB:
            return self.text(self.num(sizes[c - 0xD9]))
        if c in (0xDC, 0xDD):
            return self.seq(self.num(sizes[c - 0xDB]))
        if c in (0xDE, 0xDF):
            return self.map(self.num(sizes[c - 0xDD]))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        if 0xC7 <= c <= 0xC9:
            return self.ext(self.num(sizes[c - 0xC7]))
        raise ValueError(f"unsupported msgpack type byte {c:#04x}")


# -- the API --------------------------------------------------------------

def serialize(tree, sort_keys=True):
    """flax ``msgpack_serialize(tree)`` (``sort_keys=False``: flax
    ``to_bytes`` of a state dict, which keeps the dicts' order)."""
    parts = []
    _pack(_prepare(tree, sort_keys), parts)
    return b"".join(parts)


def restore(data):
    """flax ``msgpack_restore(data)``: the tree, arrays as numpy."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return _unchunk_in_place(tree)

"""The msgpack subset that ``flax.serialization.msgpack_serialize`` writes and
``msgpack_restore`` reads, in pure Python: the port's checkpoints are the
JAX package's files, and the machine with the card has neither ``msgpack``
nor ``flax``.

Encoding follows ``msgpack.packb(tree, default=flax's ext packer,
strict_types=True, use_bin_type=True)`` after flax's own preparation:

* dicts are written with their keys sorted, as the ``jax.tree_util.tree_map``
  that ``msgpack_serialize`` runs first sorts them;
* None, bool, int (the smallest encoding), Python float (float64), str,
  bytes, lists (arrays) and dicts (maps); as under ``strict_types``, a
  tuple or any subclass is refused;
* an ``np.ndarray`` (or a torch tensor) is ext type 1, whose payload is
  ``packb((shape, dtype.name, arr.tobytes('C')))``; a numpy scalar is ext
  type 3 with the same payload at shape ``()``; torch's bfloat16 is written
  with dtype ``bfloat16``, as ml_dtypes names it;
* a numpy array leaf of a dict over :data:`MAX_CHUNK_SIZE` bytes is split
  as flax splits it: ``{'__msgpack_chunked_array__': True, 'shape': {'0': ...},
  'chunks': {'0': ...}}`` of flat pieces.

Decoding walks a ``memoryview`` with an offset (no re-slicing of bytes, so a
130 MB train state reads in one pass), gives ndarrays as read-only numpy
views of the input, numpy scalars for ext 3, bfloat16 arrays as
``torch.bfloat16`` tensors (through a uint16 view), and joins chunked
arrays. Anything outside the subset raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# ---- encoding --------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    for lo, hi, code, fmt in ((0x80, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0x100, 0xFFFF, 0xCD, ">H"), (-0x8000, -0x81, 0xD1, ">h"),
                              (0x10000, 0xFFFFFFFF, 0xCE, ">I"),
                              (-0x80000000, -0x8001, 0xD2, ">i"),
                              (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -0x80000001, 0xD3, ">q")):
        if lo <= n <= hi:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int]) -> bytes:
    """The header of a str/bin/array/map of ``n`` elements: the fix form up
    to ``fix_max``, else the 8-, 16- or 32-bit length form (``codes``; a 0
    code means the width does not exist for this type)."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= hi:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of {n} elements is too large")


def _ext(code: int, parts: list) -> list:
    """An ext object of ``code`` over the concatenation of ``parts``."""
    n = sum(len(x) for x in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    head = bytes((fixed,)) if fixed else _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return [head + struct.pack("b", code), *parts]


def _array_parts(arr) -> list:
    """flax's ``_ndarray_to_bytes``, ``packb((shape, dtype name, C bytes))``,
    as parts: the array's data goes in as a view, not a copy."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, a = "bfloat16", t.view(torch.int16).numpy()
        else:
            a = t.numpy()
            name = a.dtype.name
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serializable")
        a, name = (arr if arr.flags.c_contiguous else arr.copy(order="C")), arr.dtype.name
    data = memoryview(a.reshape(-1)).cast("B")
    head = [b"\x93", _sized(a.ndim, 0x90, 15, (0, 0xDC, 0xDD))]
    head += [_int(int(d)) for d in a.shape]
    _pack(name, head, False)
    head.append(_sized(len(data), None, 0, (0xC4, 0xC5, 0xC6)))
    return [b"".join(head), data]


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _pack(obj, out: list, sort_keys: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        raw = obj.encode("utf-8")
        out.append(_sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw)
    elif t is bytes:
        out.append(_sized(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + obj)
    elif t is list:
        out.append(_sized(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out, sort_keys)
    elif t is dict:
        out.append(_sized(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
        for k in (sorted(obj) if sort_keys else obj):
            v = obj[k]
            _pack(k, out, sort_keys)
            if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_SIZE:
                _pack(_chunk(v), out, False)  # flax chunks after its sort: insertion order
            else:
                _pack(v, out, sort_keys)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        out += _ext(EXT_NDARRAY, _array_parts(obj))
    elif isinstance(obj, np.generic):
        out += _ext(EXT_NPSCALAR, _array_parts(np.asarray(obj)))
    else:
        raise ValueError(f"cannot serialize a {t.__name__} in flax's msgpack format")


def _parts(tree) -> list:
    out: list = []
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        _pack(_chunk(tree), out, False)
    else:
        _pack(tree, out, True)
    return out


def packb(tree) -> bytes:
    """Encode ``tree`` as ``flax.serialization.msgpack_serialize`` does
    (dict keys sorted, large array leaves of dicts chunked)."""
    return b"".join(_parts(tree))


def dump(tree, path) -> None:
    """:func:`packb` written to ``path``, the array data straight from the
    arrays (no copy into one bytes object first)."""
    with open(path, "wb") as f:
        f.writelines(_parts(tree))


# ---- decoding --------------------------------------------------------------

_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, width: int) -> int:
        return struct.unpack(_LEN[width], self.take(width))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
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
        if b in _FIXED:
            fmt = _FIXED[b]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.length(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 << (b - 0xDE)))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.length(1 << (b - 0xC7)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside flax's subset")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"a map key must be str or bytes, got {type(k).__name__}")
            out[k] = self.read()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = struct.unpack("b", self.take(1))[0]
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is outside flax's subset")
        if self.take(1)[0] != 0x93:
            raise ValueError("an ndarray ext must hold (shape, dtype, bytes)")
        shape, name, raw = tuple(self.read()), self.read(), self.read_bin()
        if self.pos != end:
            raise ValueError("an ndarray ext has trailing bytes")
        arr = _array(shape, name, raw)
        if code == EXT_NPSCALAR:
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        return arr

    def read_bin(self) -> memoryview:
        b = self.take(1)[0]
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("an ndarray's data must be msgpack bin")
        return self.take(self.length(1 << (b - 0xC4)))


def _array(shape: tuple, name, raw: memoryview):
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        u16 = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(u16.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    pieces = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(pieces[0], torch.Tensor):
        return torch.cat(pieces).reshape(shape)
    return np.concatenate(pieces).reshape(shape)


def unpackb(data):
    """Decode what :func:`packb` (or flax's ``msgpack_serialize``) wrote."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return out

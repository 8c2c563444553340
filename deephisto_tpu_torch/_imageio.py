"""A PNG reader in numpy and ``zlib``, so that the port reads PNG images
(request bodies of the serving daemon, PNG patches of a test set) where
Pillow is not installed; the port writes its images through Pillow, as the
JAX package does.

:func:`read_png` reads 8-bit, non-interlaced greyscale, grey+alpha, RGB and
RGBA files (PIL's ``convert("RGB")``: grey is repeated, alpha dropped) and
undoes all five row filters: None, Sub (a cumulative sum mod 256), Up (a
row add), and Average and Paeth (a per-pixel loop). Anything else raises
``ValueError``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter_slow(kind: int, cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4), byte by byte as the PNG spec states them."""
    out = [int(v) for v in cur]
    up = [int(v) for v in prev]
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, dtype=np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("a PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace} is not read (8-bit grey/RGB[A], no interlace only)")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    stride = 1 + w * bpp
    if raw.size != h * stride:
        raise ValueError("PNG image data of the wrong size")
    raw = raw.reshape(h, stride)
    out = np.empty((h, w * bpp), dtype=np.uint8)
    prev = np.zeros(w * bpp, dtype=np.uint8)
    for y in range(h):
        kind, cur = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            row = cur
        elif kind == 1:
            row = np.cumsum(cur.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = cur + prev
        elif kind in (3, 4):
            row = _unfilter_slow(kind, cur, prev, bpp)
        else:
            raise ValueError(f"PNG row filter {kind} does not exist")
        out[y] = row
        prev = out[y]
    img = out.reshape(h, w, bpp)
    if colour in (0, 4):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_png(path: Path | str) -> np.ndarray:
    return decode_png(Path(path).read_bytes())

"""Polygon rasterization to pixel masks with numpy (host-side, for synthetic
slide generation). The JAX package fills polygons with PIL
(``deephisto_tpu/geometry/raster.py``); the machine with the card has no
PIL, so the port fills them itself: an even-odd scanline fill that samples
each pixel at its integer (x, y) position and includes the pixels that the
polygon's outline crosses on their row, as PIL's ``polygon(outline=1,
fill=1)`` does. The masks need not be pixel-equal to PIL's."""

from __future__ import annotations

import numpy as np


def polygon_mask(vertices_xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """Boolean (h, w) mask of pixels inside the polygon (even-odd rule)."""
    v = np.asarray(vertices_xy, dtype=np.float64)
    mask = np.zeros((int(h), int(w)), dtype=bool)
    if len(v) < 3:
        return mask
    ys = np.arange(max(0, int(np.floor(v[:, 1].min()))), min(int(h), int(np.ceil(v[:, 1].max())) + 1))
    if len(ys) == 0:
        return mask
    a, b = v, np.roll(v, -1, axis=0)
    yf = ys[:, None].astype(np.float64)  # (rows, 1) sample rows
    lo, hi = np.minimum(a[:, 1], b[:, 1]), np.maximum(a[:, 1], b[:, 1])
    cross = (yf >= lo) & (yf < hi)  # half-open: a shared vertex counts once
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (yf - a[:, 1]) / (b[:, 1] - a[:, 1])
    xs = np.where(cross, a[:, 0] + t * (b[:, 0] - a[:, 0]), np.inf)
    xs.sort(axis=1)  # crossings of each row, left to right, misses (inf) last
    n_cross = cross.sum(axis=1)
    diff = np.zeros((len(ys), int(w) + 1), dtype=np.int32)
    for i in range(0, xs.shape[1] - 1, 2):  # spans between crossing pairs
        ok = n_cross > i + 1
        x0 = np.clip(np.ceil(xs[ok, i] - 0.5), 0, w).astype(np.int64)
        x1 = np.clip(np.floor(xs[ok, i + 1] + 0.5) + 1, 0, w).astype(np.int64)
        rows = np.nonzero(ok)[0]
        np.add.at(diff, (rows, x0), 1)
        np.add.at(diff, (rows, np.maximum(x0, x1)), -1)
    mask[ys] = np.cumsum(diff[:, : int(w)], axis=1) > 0
    return mask

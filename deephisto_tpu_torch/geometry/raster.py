"""Polygon rasterization to pixel masks with numpy (host-side), a port of
``deephisto_tpu/geometry/raster.py``.

Two fills:

* :func:`multi_class_mask` is the JAX function pixel for pixel: it fills
  each polygon with a port of PIL's own routine (``ImagingDrawPolygon``
  with ``fill=1``: the vertices truncated to ints, the edge list with a
  horizontal edge merged into the one before it, the scanline fill with
  float32 crossings of double-precision slopes and PIL 12's corner
  joining), which the JAX function reaches through
  ``ImageDraw.polygon(outline=1, fill=1)``. Only a polygon
  that comes back to one of its vertices (a retraced spike, a figure
  eight) may still differ from PIL by a few pixels on the vertex's row.
  The annotation overlays (``anno/visualize.py``) draw with the same
  routine.
* :func:`polygon_mask` is an even-odd scanline fill that samples each pixel
  at its integer (x, y) position and includes the pixels that the outline
  crosses on their row. The synthetic slides are drawn with it; its masks
  need not be pixel-equal to PIL's.

The module imports no PIL.
"""

from __future__ import annotations

import math

import numpy as np


def _round_up(f: float) -> int:
    """PIL's ROUND_UP, C's ``roundf``: half away from zero (``np.round``
    rounds half to even)."""
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    """PIL's ROUND_DOWN."""
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


def _edge(x0: int, y0: int, x1: int, y1: int) -> dict:
    """PIL's ``add_edge``: the slope in double precision."""
    dx = 0.0 if y0 == y1 else (x1 - x0) / (y1 - y0)
    return {"xmin": min(x0, x1), "xmax": max(x0, x1), "ymin": min(y0, y1),
            "ymax": max(y0, y1), "dx": dx, "x0": x0, "y0": y0}


def _x_at(e: dict, y: int) -> float:
    """The edge's x on row y, in double precision."""
    return (y - e["y0"]) * e["dx"] + e["x0"]


def _fill_edges(mask: np.ndarray, edges: list[dict], ink: bool = True) -> None:
    """PIL's scanline fill (``polygon_generic`` without antialiasing) of
    an edge list into a boolean (h, w) mask: each row's crossings computed
    in double and kept in float32, paired left to right, each span
    [ROUND_UP(a), ROUND_DOWN(b)]; horizontal edges drawn as they are;
    corners joined as PIL joins them."""
    h, w = mask.shape

    def hline(x0: int, y: int, x1: int) -> None:
        if 0 <= y < h and x0 < w and x1 >= 0:
            mask[y, max(x0, 0) : min(x1, w - 1) + 1] = ink

    table = []
    ymin, ymax = h - 1, 0
    for e in edges:
        ymin, ymax = min(ymin, e["ymin"]), max(ymax, e["ymax"])
        if e["ymin"] == e["ymax"]:
            hline(e["xmin"], e["ymin"], e["xmax"])
        else:
            table.append(e)
    for y in range(max(ymin, 0), min(ymax, h) + 1):
        xx: list[np.float32] = []
        for i, cur in enumerate(table):
            if not cur["ymin"] <= y <= cur["ymax"]:
                continue
            xx.append(np.float32(_x_at(cur, y)))
            if y == cur["ymax"] and y < ymax:
                xx.append(xx[-1])  # PIL: "needed to draw consistent polygons"
            elif cur["dx"] != 0 and len(xx) % 2 == 1 and _round_up(float(xx[-1])) == xx[-1]:
                for k, other in enumerate(table):  # PIL: "connect discontiguous corners"
                    if k == i:
                        continue
                    if (cur["dx"] > 0 and other["dx"] <= 0) or (cur["dx"] < 0 and other["dx"] >= 0):
                        continue
                    if (((y == cur["ymin"] and y == other["ymin"])
                         or (y == cur["ymax"] and y == other["ymax"]))
                            and float(xx[-1]) == _x_at(other, y)):
                        # the two edges' crossings on the next row (the
                        # previous one at the current edge's bottom)
                        off = -1 if y == cur["ymax"] else 1
                        if other["ymin"] <= y + off <= other["ymax"]:
                            a, b = _x_at(cur, y + off), _x_at(other, y + off)
                            x = float(xx[-1])
                            if x > a + 1 and x > b + 1:
                                xx[-1] = np.float32(_round_up(max(a, b)) + 1)
                            elif x < a - 1 and x < b - 1:
                                xx[-1] = np.float32(_round_up(min(a, b)) - 1)
                            break
        xx.sort()
        for i in range(1, len(xx), 2):
            x_start, x_end = _round_up(float(xx[i - 1])), _round_down(float(xx[i]))
            if x_end >= x_start:
                hline(x_start, y, x_end)


def _int_vertices(vertices) -> list[tuple[int, int]]:
    """The vertices as PIL's ``draw_polygon`` takes them: truncated to ints."""
    return [(int(x), int(y)) for x, y in vertices]


def _polygon_fill(ixy: list[tuple[int, int]], h: int, w: int) -> np.ndarray:
    """PIL's ``ImagingDrawPolygon(fill=1)`` as an (h, w) boolean mask: the
    edge list (a horizontal edge right after another one in the same
    direction merged into it), then the scanline fill."""
    edges: list[dict] = []
    n = len(ixy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = ixy[i], ixy[i + 1]
        if y0 == y1 and i != 0 and y0 == ixy[i - 1][1]:
            if x1 > x0 > ixy[i - 1][0]:
                edges[-1]["xmax"] = x1
                continue
            if x1 < x0 < ixy[i - 1][0]:
                edges[-1]["xmin"] = x1
                continue
        edges.append(_edge(x0, y0, x1, y1))
    if ixy[-1] != ixy[0]:
        edges.append(_edge(*ixy[-1], *ixy[0]))
    mask = np.zeros((h, w), dtype=bool)
    _fill_edges(mask, edges)
    return mask


def polygon_mask(
    vertices_xy: np.ndarray, h: int, w: int, scale: float = 1.0
) -> np.ndarray:
    """Boolean (h, w) mask of pixels inside the polygon (even-odd rule), with
    vertices scaled by ``scale`` first (e.g. 1/layer for pyramid layers)."""
    v = np.asarray(vertices_xy, dtype=np.float64) * scale
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


def multi_class_mask(
    annotations: list[tuple[int, np.ndarray]],
    h: int,
    w: int,
    scale: float = 1.0,
    background: int = -1,
) -> np.ndarray:
    """(h, w) int32 class-id map from [(class_id, vertices_xy), ...] with
    PIL's polygon fill (module docstring), vertices scaled by ``scale``
    first; later polygons paint over earlier ones; untouched pixels get
    ``background``."""
    out = np.full((h, w), background, dtype=np.int32)
    for cls_id, verts in annotations:
        v = np.asarray(verts, dtype=np.float64) * scale
        out[_polygon_fill(_int_vertices(v), h, w)] = cls_id
    return out

"""Exact polygon math on the host (numpy), copied from
``deephisto_tpu/geometry/polygon.py`` (the port keeps its own copy).
``clip_area_boxes`` hands batches of 64 boxes and more to the port's own
C++/OpenMP library (``deephisto_tpu_torch/native``) where it builds, as the
JAX package does, and takes the numpy path otherwise.

Replaces the reference's shapely usage (polygon area at reference
region_samplers.py:73, patch∩region intersection areas at :133-134 and
:188-189, bounds at :116, validity repair at :69-71) with a dependency-free,
fixed-shape algorithm that also runs on device (see geometry/device.py):

**Clip-by-clamp with edge subdivision.** To compute area(P ∩ Box) for a simple
polygon P and an axis-aligned box, split every edge at its crossings with the
four box lines (at most 4 interior crossings per edge → 5 emitted vertices per
edge, a *fixed* budget), clamp every emitted vertex into the box, and take the
shoelace area of the resulting 5V-gon. Outside portions collapse onto the box
boundary, tracing exactly the path Sutherland–Hodgman would produce, so the
result is exact for simple polygons — with no data-dependent shapes and no
sequential clip passes, which is what makes it vectorize on the TPU VPU.
"""

from __future__ import annotations

import numpy as np


def shoelace_area(vertices: np.ndarray) -> float:
    """Unsigned area of a polygon given (V, 2) vertices as (x, y)."""
    x = vertices[:, 0]
    y = vertices[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)) / 2.0)


def signed_shoelace_area(vertices: np.ndarray) -> float:
    """Signed area (positive for counter-clockwise orientation in xy)."""
    x = vertices[:, 0]
    y = vertices[:, 1]
    return float((np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)) / 2.0)


def polygon_bounds(vertices: np.ndarray) -> tuple[float, float, float, float]:
    """(x0, y0, x1, y1) bounding box — same tuple order as shapely's
    ``polygon.bounds`` relied on at reference region_samplers.py:116."""
    return (
        float(vertices[:, 0].min()),
        float(vertices[:, 1].min()),
        float(vertices[:, 0].max()),
        float(vertices[:, 1].max()),
    )


def find_self_intersections(
    vertices: np.ndarray, eps: float = 1e-9
) -> list[tuple[int, int, float, float, np.ndarray]]:
    """Proper crossings between non-adjacent edges of a closed ring.

    Returns ``[(i, j, t_i, t_j, point), ...]`` with ``i < j`` edge indices and
    parametric positions along each edge. Block-vectorized numpy — O(V²) work
    but no Python-level pair loop, so multi-thousand-vertex annotations stay
    fast (the round-1 implementation was a quadratic Python loop).
    """
    v = np.asarray(vertices, dtype=np.float64)
    n = len(v)
    if n < 4:
        return []
    a = v
    d = np.roll(v, -1, axis=0) - a  # (n, 2) edge vectors
    # contiguous 1-D components: broadcasting strided (b, 1, 2)/(1, n, 2)
    # views pushes numpy's ufunc loop off its SIMD fast path (~20× slower
    # for these block shapes), so the pair math runs on x/y copies instead
    ax, ay = np.ascontiguousarray(a[:, 0]), np.ascontiguousarray(a[:, 1])
    dx, dy = np.ascontiguousarray(d[:, 0]), np.ascontiguousarray(d[:, 1])

    out: list[tuple[int, int, float, float, np.ndarray]] = []
    block = 512
    jj = np.arange(n)[None, :]
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        ii = np.arange(i0, i1)[:, None]
        dix, diy = dx[i0:i1, None], dy[i0:i1, None]  # (b, 1)
        denom = dix * dy[None, :] - diy * dx[None, :]  # (b, n)
        diffx = ax[None, :] - ax[i0:i1, None]  # (b, n)
        diffy = ay[None, :] - ay[i0:i1, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            ti = (diffx * dy[None, :] - diffy * dx[None, :]) / denom
            tj = (diffx * diy - diffy * dix) / denom
        adjacent = (
            (jj == ii) | (jj == (ii + 1) % n) | (jj == (ii - 1) % n)
        )
        ok = (
            (jj > ii)
            & ~adjacent
            & (np.abs(denom) > eps)
            & np.isfinite(ti)
            & np.isfinite(tj)
            & (ti > eps)
            & (ti < 1 - eps)
            & (tj > eps)
            & (tj < 1 - eps)
        )
        for bi, j in zip(*np.nonzero(ok)):
            i = i0 + int(bi)
            t = float(ti[bi, j])
            out.append((i, int(j), t, float(tj[bi, j]), a[i] + t * d[i]))
    return out


def is_simple_polygon(vertices: np.ndarray, eps: float = 1e-9) -> bool:
    """True if no two non-adjacent edges properly intersect (stands in for
    shapely's ``is_valid`` at reference region_samplers.py:69)."""
    v = np.asarray(vertices, dtype=np.float64)
    if len(v) < 3:
        return False
    return not find_self_intersections(v, eps)


def repair_polygon(vertices: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Resolve a self-intersecting ring into a valid region, like the
    reference's shapely ``buffer(0)`` repair (region_samplers.py:69-71).

    The ring is split at every proper self-crossing into simple loops (stack
    walk over the subdivided vertex sequence). Loops whose orientation matches
    the ring's dominant (net) orientation are kept — the inverted slivers an
    accidental bowtie creates are dropped, which is exactly what GEOS
    ``buffer(0)`` does to them; if the net signed area is zero (perfectly
    symmetric figure-8) the largest loop is kept. Multiple kept loops are
    re-joined with zero-width keyhole bridges so the result stays one vertex
    array: a bridge edge traversed forward then backward cancels exactly in
    the shoelace sum, both for the full area and under clip-by-clamp, so
    ``shoelace_area``/``clip_area_*`` on the repaired ring equal the sums over
    the kept loops.

    Simple inputs are returned unchanged.
    """
    v = np.asarray(vertices, dtype=np.float64)
    # drop an explicit closing duplicate so the wrap-around edge isn't doubled
    if len(v) > 1 and np.array_equal(v[0], v[-1]):
        v = v[:-1]
    crossings = find_self_intersections(v, eps)
    if not crossings:
        return v

    # subdivided ring: original vertices + crossing points (each crossing
    # appears twice, once per edge, with identical coordinates)
    per_edge: dict[int, list[tuple[float, int]]] = {}
    points: dict[int, np.ndarray] = {}
    for cid, (i, j, ti, tj, pt) in enumerate(crossings):
        per_edge.setdefault(i, []).append((ti, cid))
        per_edge.setdefault(j, []).append((tj, cid))
        points[cid] = pt
    seq: list[tuple[np.ndarray, int | None]] = []
    for i in range(len(v)):
        seq.append((v[i], None))
        for _, cid in sorted(per_edge.get(i, [])):
            seq.append((points[cid], cid))

    # stack decomposition: a repeated crossing id closes the loop opened at
    # its first occurrence
    loops: list[np.ndarray] = []
    stack: list[tuple[np.ndarray, int | None]] = []
    open_idx: dict[int, int] = {}
    for coord, cid in seq:
        if cid is not None and cid in open_idx:
            j = open_idx.pop(cid)
            loops.append(np.asarray([c for c, _ in stack[j:]]))
            for k in [k for k, idx in open_idx.items() if idx > j]:
                del open_idx[k]  # crossings consumed inside the popped loop
            del stack[j + 1 :]  # the crossing itself stays on the outer path
        else:
            if cid is not None:
                open_idx[cid] = len(stack)
            stack.append((coord, cid))
    if len(stack) >= 3:
        loops.append(np.asarray([c for c, _ in stack]))

    loops = [l for l in loops if len(l) >= 3]
    if not loops:
        return v
    signed = np.array([signed_shoelace_area(l) for l in loops])
    total = signed.sum()
    if abs(total) > eps:
        kept = [l for l, s in zip(loops, signed) if s * total > 0 and abs(s) > eps]
    else:
        kept = []
    if not kept:  # symmetric figure-8 (net zero): keep the largest lobe
        kept = [loops[int(np.argmax(np.abs(signed)))]]

    # keyhole-bridge concatenation: ... A..., b0, ...B..., b0, a_last
    merged = list(kept[0])
    for loop in kept[1:]:
        back = merged[-1]
        merged.extend(loop)
        merged.append(loop[0])
        merged.append(back)
    return np.asarray(merged, dtype=np.float64)


def _subdivide_and_clamp(verts: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Split each edge of one polygon at the crossings of each box's lines
    and clamp into the box.

    verts: (V, 2) float64; boxes: (B, 4) float64 [x0, y0, x1, y1]. Returns
    (B, 5V, 2): box b's collapsed polygon, whose shoelace area is the
    intersection's.
    """
    B, V = boxes.shape[0], verts.shape[0]
    a = np.broadcast_to(verts, (B, V, 2))
    b = np.roll(a, -1, axis=1)
    d = b - a

    x0 = boxes[:, 0][:, None]
    y0 = boxes[:, 1][:, None]
    x1 = boxes[:, 2][:, None]
    y1 = boxes[:, 3][:, None]

    with np.errstate(divide="ignore", invalid="ignore"):
        ts = np.stack(
            [
                (x0 - a[..., 0]) / d[..., 0],
                (x1 - a[..., 0]) / d[..., 0],
                (y0 - a[..., 1]) / d[..., 1],
                (y1 - a[..., 1]) / d[..., 1],
            ],
            axis=2,
        )  # (B, V, 4)
    # crossings outside (0, 1) — including parallel/NaN — degrade to t=1 (a
    # duplicate of the edge end, which adds zero shoelace area)
    ts = np.where(np.isfinite(ts) & (ts > 0.0) & (ts < 1.0), ts, 1.0)
    ts = np.sort(ts, axis=2)

    pts = a[:, :, None, :] + ts[..., None] * d[:, :, None, :]  # (B, V, 4, 2)
    out = np.concatenate([a[:, :, None, :], pts], axis=2).reshape(B, 5 * V, 2)
    np.clip(out[..., 0], x0, x1, out=out[..., 0])
    np.clip(out[..., 1], y0, y1, out=out[..., 1])
    return out


def clip_area_box(
    vertices: np.ndarray, x0: float, y0: float, x1: float, y1: float
) -> float:
    """Exact area of polygon ∩ [x0,x1]×[y0,y1] for a simple polygon.

    Mirrors ``polygon.intersection(patch_polygon).area`` at reference
    region_samplers.py:133 for axis-aligned patches.
    """
    v = np.asarray(vertices, dtype=np.float64)
    box = np.array([[x0, y0, x1, y1]], dtype=np.float64)
    return shoelace_area(_subdivide_and_clamp(v, box)[0])


def clip_area_boxes(vertices: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Exact areas of polygon ∩ box for (B, 4) boxes [x0, y0, x1, y1] and a
    simple polygon (mirrors ``polygon.intersection(patch_polygon).area`` at
    reference region_samplers.py:133 for axis-aligned patches).

    Returns (B,) float64 intersection areas. Host-side batch path used by
    dense-grid qualification and anchor precomputation; the device version
    lives in geometry/device.py. Dispatches to the C++/OpenMP native library
    when it builds (same algorithm, the same results).
    """
    if len(boxes) >= 64:
        from .. import native

        if native.available():
            return native.clip_area_boxes_native(vertices, boxes)
    return _clip_area_boxes_numpy(vertices, boxes)


def _clip_area_boxes_numpy(vertices: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """:func:`clip_area_boxes` in numpy."""
    out = _subdivide_and_clamp(np.asarray(vertices, dtype=np.float64),
                               np.asarray(boxes, dtype=np.float64))
    x = out[..., 0]
    y = out[..., 1]
    return np.abs(
        np.einsum("bv,bv->b", x, np.roll(y, -1, axis=1))
        - np.einsum("bv,bv->b", np.roll(x, -1, axis=1), y)
    ) / 2.0

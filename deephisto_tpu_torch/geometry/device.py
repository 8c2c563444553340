"""Exact polygon∩box areas on the device, a port of
``deephisto_tpu/geometry/device.py`` to torch: fixed shapes, branch-free.

The clip-by-clamp-with-subdivision algorithm of geometry/polygon.py as a
batched tensor program: every trial box is shifted into its own local frame
before clamping so all shoelace products stay small (≤ patch_size²), keeping
float32 exact enough for the accept/reject threshold ``area > ps²·ri``. The
sampler runs it on its rejection trials (ROADMAP queue B, B8: plain torch
ops here; a kernel waits for a profile that asks for one).

Padding convention: polygons are padded to a fixed MAX_V by repeating their
last vertex. Duplicate vertices produce zero-length edges, which contribute
zero crossings and zero shoelace area — no validity mask needed anywhere.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_polygon(vertices: np.ndarray, max_v: int) -> np.ndarray:
    """Pad (V, 2) → (max_v, 2) by repeating the last vertex."""
    v = np.asarray(vertices, dtype=np.float32)
    if len(v) > max_v:
        raise ValueError(f"polygon with {len(v)} vertices exceeds max_v={max_v}")
    if len(v) == max_v:
        return v
    return np.concatenate([v, np.repeat(v[-1:], max_v - len(v), axis=0)], axis=0)


def pad_polygons(vertex_lists: list[np.ndarray], max_v: int) -> np.ndarray:
    """Stack a list of polygons into (R, max_v, 2) float32."""
    return np.stack([pad_polygon(v, max_v) for v in vertex_lists], axis=0)


def clip_area_batch(verts: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """areas (B,) of polygon_b ∩ box_b.

    verts: (B, V, 2) padded polygons as (x, y), float32.
    boxes: (B, 4) as (x0, y0, x1, y1), float32.
    """
    corner = boxes[:, None, 0:2]  # (B, 1, 2)
    wh = boxes[:, None, 2:4] - corner  # (B, 1, 2) box extents

    a = verts - corner  # box-local frame
    b = torch.roll(a, -1, dims=1)
    d = b - a  # (B, V, 2)

    # edge parameters of crossings with the 4 box lines (x=0, x=w, y=0, y=h)
    ts = torch.stack(
        [
            (0.0 - a[..., 0]) / d[..., 0],
            (wh[..., 0] - a[..., 0]) / d[..., 0],
            (0.0 - a[..., 1]) / d[..., 1],
            (wh[..., 1] - a[..., 1]) / d[..., 1],
        ],
        dim=-1,
    )  # (B, V, 4); zero-length edges divide 0/0 → NaN → filtered below
    ts = torch.where(torch.isfinite(ts) & (ts > 0.0) & (ts < 1.0), ts, 1.0)
    ts = torch.sort(ts, dim=-1).values

    pts = a[:, :, None, :] + ts[..., None] * d[:, :, None, :]  # (B, V, 4, 2)
    out = torch.cat([a[:, :, None, :], pts], dim=2)  # (B, V, 5, 2)
    n, v = a.shape[0], a.shape[1]
    out = out.reshape(n, 5 * v, 2)
    out = torch.minimum(out.clamp_min(0.0), wh)  # clamp into the box-local frame

    x = out[..., 0]
    y = out[..., 1]
    area2 = (x * torch.roll(y, -1, dims=1)).sum(dim=1) - (torch.roll(x, -1, dims=1) * y).sum(dim=1)
    return area2.abs() * 0.5


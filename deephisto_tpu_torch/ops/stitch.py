"""Stitching: scatter-add per-patch values into downscaled whole-slide maps,
and the coverage accumulator of the random samplers.

Port of ``deephisto_tpu/ops/stitch.py``. ``scatter_add_map`` is kernel
K2 (``csrc/stitch.cu``): deterministic, each map cell summing its covering
patches in index order, as XLA's scatter and the plain loop do. Unlike the
JAX functions, which return a new map, these add into ``acc_map`` in place
(one map copy saved per batch) and return it.

Map indices follow JAX's ``.at[yy, xx].add(mode="drop")``: one in
[-dh, 0) (or [-dw, 0)) is first wrapped to the far edge, then every cell
still off the map is dropped.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

KERNEL = "scatter_add_map"
_SIGNATURE = {
    "dh_scatter_add_map": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
}


def map_footprint(patch_size: int, downscale: int) -> int:
    """Cells a patch spans per axis in a downscaled score map, at least 1
    (exact for every position when ``downscale`` divides ``patch_size``;
    otherwise use :func:`scatter_add_map_exact`)."""
    return max(1, patch_size // downscale)


def coverage_footprint(patch_size: int, downscale: int) -> int:
    """Cells to mark per axis in a coverage accumulator: one more than the
    floor span, so every cell is reachable (ops/stitch.py:54-65)."""
    return patch_size // downscale + 1


def _axis_parts(y: int, span: int, extent: int):
    """The index ranges [lo, hi) of one axis that a footprint [y, y + span)
    adds to: its cells on the map, then the wraps of its indices in
    [-extent, 0) (empty ranges dropped)."""
    parts = ((max(y, 0), min(y + span, extent)), (max(y + extent, 0), min(y + span, 0) + extent))
    return [(lo, hi) for lo, hi in parts if lo < hi]


def scatter_add_map_ref(acc_map, coords, values, footprint: int, spans=None):
    """Plain version of K2: the sequential loop, patch by patch in index
    order (the reference's host ``+=``), each patch added to the up to four
    rectangles its wrapped footprint covers."""
    dh, dw = acc_map.shape[0], acc_map.shape[1]
    vals = values.reshape(values.shape[0], -1).to(acc_map.dtype)
    cs = torch.as_tensor(coords).tolist()
    sp = None if spans is None else torch.as_tensor(spans).tolist()
    for i, (y, x) in enumerate(cs):
        sy, sx = (footprint, footprint) if sp is None else (
            max(0, min(sp[i][0], footprint)), max(0, min(sp[i][1], footprint))
        )
        for y0, y1 in _axis_parts(y, sy, dh):
            for x0, x1 in _axis_parts(x, sx, dw):
                acc_map[y0:y1, x0:x1] += vals[i]
    return acc_map


def _int_pairs(t, n: int, device, what: str) -> torch.Tensor:
    t = torch.as_tensor(t)
    if t.dtype != torch.int32 or tuple(t.shape) != (n, 2):
        raise ValueError(f"{what} must be ({n}, 2) int32, got {tuple(t.shape)} {t.dtype}")
    return t.to(device, non_blocking=True).contiguous()


def scatter_add_map(
    acc_map: torch.Tensor, coords, values: torch.Tensor, footprint: int, spans=None
) -> torch.Tensor:
    """K2: add ``values[i]`` over the f×f footprint of each patch, in place.

    acc_map: (dh, dw, C) float32 contiguous accumulator.
    coords:  (N, 2) int32 patch corners already divided by the downscale.
    values:  (N, C), or (N,) for a C == 1 map; added as float32.
    spans:   optional (N, 2) int32 per-patch (y, x) spans; offsets at or
             past min(span, footprint) add nothing (the d ∤ ps case).

    A map on the CPU takes the plain loop; a map on a CUDA device launches
    the kernel (built at first use), and raises if it cannot.
    """
    if acc_map.dtype != torch.float32 or acc_map.ndim != 3 or not acc_map.is_contiguous():
        raise ValueError(
            f"acc_map must be a contiguous (dh, dw, C) float32 tensor, got "
            f"{tuple(acc_map.shape)} {acc_map.dtype}"
        )
    dev = acc_map.device
    n, ch = values.shape[0], acc_map.shape[2]
    values = values.reshape(n, -1)
    if values.shape[1] != ch:
        raise ValueError(f"values carry {values.shape[1]} channels, the map {ch}")
    coords = _int_pairs(coords, n, dev, "coords")
    if spans is not None:
        spans = _int_pairs(spans, n, dev, "spans")
    if dev.type == "cpu":
        return scatter_add_map_ref(acc_map, coords, values, footprint, spans)
    if dev.type != "cuda":
        raise ValueError(f"scatter_add_map runs on cpu or cuda, not {dev}")

    values = values.to(device=dev, dtype=torch.float32).contiguous()
    lib = _build.load("stitch", _SIGNATURE)
    err = lib.dh_scatter_add_map(
        dev.index, acc_map.data_ptr(), acc_map.shape[0], acc_map.shape[1], ch,
        coords.data_ptr(), None if spans is None else spans.data_ptr(),
        values.data_ptr(), n, footprint, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return acc_map


def scatter_add_map_exact(
    acc_map: torch.Tensor, coords_raw, values: torch.Tensor, patch_size: int, downscale: int
) -> torch.Tensor:
    """Exact-parity stitch over the reference's position-dependent footprint
    ``[y//d, (y+ps)//d) × [x//d, (x+ps)//d)`` from RAW layer coords; with
    ``d | ps`` the span is constant and no spans are passed."""
    ps, d = patch_size, downscale
    coords_raw = torch.as_tensor(coords_raw).to(acc_map.device, non_blocking=True)
    if ps % d == 0:
        return scatter_add_map(acc_map, coords_raw // d, values, max(1, ps // d))
    spans = (coords_raw % d + ps) // d  # ps//d or ps//d + 1
    return scatter_add_map(acc_map, coords_raw // d, values, ps // d + 1, spans=spans)


def accumulate_coverage(accum: torch.Tensor, coords_ds, footprint: int):
    """Coverage update on K2 (ops/stitch.py:111): ``accum[footprint cells]
    += 1`` in place, footprints cut at the map's bottom and right edges (the
    cells past them dropped, as ``mode="drop"``). ``accum`` is the
    contiguous (dh, dw, 1) float32 map, which K2 takes as it is.
    Returns (accum, filled_ratio): the ratio of nonzero cells, a 0-d
    float32 tensor on accum's device (read it on the host only where
    needed)."""
    coords_ds = torch.as_tensor(coords_ds)
    ones = torch.ones((coords_ds.shape[0],), dtype=torch.float32, device=accum.device)
    scatter_add_map(accum, coords_ds, ones, footprint)
    return accum, torch.count_nonzero(accum).to(torch.float32) / accum.numel()

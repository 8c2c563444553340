"""Slide abstraction: pyramidal gigapixel images, copied from
``deephisto_tpu/slide/base.py``. The port does not depend on PIL: the
previews resize with :func:`_resize_uint8`, a port of Pillow's bilinear
resize that gives PIL's bytes, and ``to_image`` returns an (h, w, 3) uint8
array where the JAX package returns a PIL ``Image``.

The reference consumes the external ``psimage`` package (PSImage objects used at
reference patch_samplers/region_samplers.py:10-11 and full_samplers.py:11-12).
This module defines the narrow surface the framework actually needs —
``layer_size``, ``get_region_from_layer``, ``get_region``, ``to_image``,
``height``/``width``, context-manager protocol — so any pyramidal backend can
plug in (synthetic, in-memory array, on-disk tiled, or a future PSI codec).

Layer semantics match the reference (SURVEY.md §1 "Dataset contract"):
``layer`` is a power-of-two downscale factor of the pyramid; layer 1 is full
resolution. Polygon vertices are stored in layer-1 coordinates and scaled by
``1/layer``; a patch of size ``ps`` at layer ``l`` covers ``ps*l`` full-res
pixels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Patch:
    """One extracted patch (mirror of psimage's Patch dataclass used at
    reference region_samplers.py:508-523)."""

    layer: int
    pos_x: int
    pos_y: int
    patch_size: int
    data: np.ndarray  # HWC uint8

    @property
    def pos(self) -> tuple[int, int]:
        return (self.pos_y, self.pos_x)


class Slide:
    """Base class for pyramidal slides.

    Subclasses must provide ``_layer_array(layer) -> np.ndarray`` or override
    ``get_region_from_layer``. All coordinates are (y, x), regions are
    half-open ``[tl, br)``, returned data is HWC uint8.
    """

    #: full-resolution height / width (layer 1)
    height: int
    width: int
    #: available power-of-two layers, ascending, e.g. (1, 2, 4, 8)
    layers: tuple[int, ...]

    # -- core surface -------------------------------------------------------

    def layer_size(self, layer: int) -> tuple[int, int]:
        """(h, w) of the given pyramid layer."""
        self._assert_layer(layer)
        return (-(-self.height // layer), -(-self.width // layer))

    def get_region_from_layer(
        self, layer: int, tl: tuple[int, int], br: tuple[int, int]
    ) -> np.ndarray:
        """Read region ``[tl, br)`` (layer coords) from ``layer`` as HWC uint8."""
        self._assert_layer(layer)
        arr = self._layer_array(layer)
        y0, x0 = int(tl[0]), int(tl[1])
        y1, x1 = int(br[0]), int(br[1])
        h, w = arr.shape[:2]
        if not (0 <= y0 <= y1 <= h and 0 <= x0 <= x1 <= w):
            raise ValueError(
                f"region {tl}..{br} out of bounds for layer {layer} of size {(h, w)}"
            )
        return arr[y0:y1, x0:x1]

    def get_region(
        self,
        tl: tuple[int, int],
        br: tuple[int, int],
        target_hw: tuple[int, int] | None = None,
    ) -> np.ndarray:
        """Read a full-resolution region, optionally resized to ``target_hw``
        (mirror of the psimage call at reference predict_full_patched.py:104)."""
        region = self.get_region_from_layer(1, tl, br)
        if target_hw is not None and tuple(target_hw) != region.shape[:2]:
            region = _resize_uint8(region, target_hw)
        return region

    def to_image(
        self,
        max_side: int | None = None,
        scale: float | None = None,
        auto_downscale: bool = False,
        max_side_limit: int = 4096,
    ) -> np.ndarray:
        """Downscaled (h, w, 3) uint8 preview of the whole slide (mirror of
        psimage ``to_image`` used at reference anno/utils.py:295-297; the
        JAX package wraps the same pixels in a PIL ``Image``)."""
        h, w = self.height, self.width
        if scale is not None:
            th, tw = max(1, round(h * scale)), max(1, round(w * scale))
        elif max_side is not None:
            s = max_side / max(h, w)
            th, tw = max(1, round(h * s)), max(1, round(w * s))
        elif auto_downscale and max(h, w) > max_side_limit:
            s = max_side_limit / max(h, w)
            th, tw = max(1, round(h * s)), max(1, round(w * s))
        else:
            th, tw = h, w
        # read from the closest pyramid layer ≥ the target size, then resize
        layer = 1
        for l in self.layers:
            lh, lw = self.layer_size(l)
            if lh >= th and lw >= tw:
                layer = l
        lh, lw = self.layer_size(layer)
        arr = self.get_region_from_layer(layer, (0, 0), (lh, lw))
        if (th, tw) != arr.shape[:2]:
            arr = _resize_uint8(arr, (th, tw))
        return np.ascontiguousarray(arr)

    # -- helpers ------------------------------------------------------------

    def _assert_layer(self, layer: int) -> None:
        if layer not in self.layers:
            raise ValueError(f"layer {layer} not in pyramid layers {self.layers}")

    def _layer_array(self, layer: int) -> np.ndarray:
        raise NotImplementedError

    def mmap_layer(self, layer: int) -> np.ndarray | None:
        """A memory-mapped full-layer array when the backend supports
        out-of-core reads (overridden by DHSlide), else None. Callers use this
        for slides larger than host RAM; region reads then touch only the
        pages needed."""
        return None

    def close(self) -> None:  # noqa: B027 - optional hook
        pass

    def __enter__(self) -> "Slide":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_pyramid(level0: np.ndarray, max_layer: int) -> dict[int, np.ndarray]:
    """Build power-of-two pyramid layers {1: level0, 2: ..., max_layer: ...}
    by 2x2 mean pooling (edge-padded to even sizes at each step)."""
    if level0.dtype != np.uint8 or level0.ndim != 3 or level0.shape[2] != 3:
        raise ValueError("level0 must be HWC uint8 RGB")
    layers = {1: level0}
    cur = level0
    l = 1
    while l < max_layer:
        h, w = cur.shape[:2]
        ph, pw = h + (h % 2), w + (w % 2)
        if (ph, pw) != (h, w):
            cur = np.pad(cur, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
        # the 2x2 sum in uint16 from four strided views (the JAX package's
        # reshape-and-sum computes the same values, several times slower)
        total = cur[0::2, 0::2].astype(np.uint16)
        total += cur[1::2, 0::2]
        total += cur[0::2, 1::2]
        total += cur[1::2, 1::2]
        pooled = (total // 4).astype(np.uint8)
        l *= 2
        layers[l] = pooled
        cur = pooled
    return layers


# Pillow's fixed point for 8-bit resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` with the triangle filter, then
    ``normalize_coeffs_8bpc``: for each output position its first input
    index (n,) and its taps' fixed-point weights (n, k), 0 past the taps it
    has. The filter's support grows with the downscale factor (antialiased)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.floor(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.floor(center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    weights = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for t in range(ksize):  # one tap at a time: Pillow's summation order
        x = np.abs((xmin + t - center + 0.5) * ss)
        w = np.where((t < xmax) & (x < 1.0), 1.0 - x, 0.0)
        weights[:, t] = w
        ww += w
    weights /= np.where(ww != 0.0, ww, 1.0)[:, None]
    fixed = np.floor(0.5 + weights * (1 << _PRECISION_BITS)).astype(np.int32)
    return xmin, fixed


_BAND_OUTPUTS = 32  # outputs of one banded block product
_CHUNK_ELEMENTS = 1 << 21  # input elements converted at once (16 MB in f64: in cache)


def _band_blocks(start: np.ndarray, weights: np.ndarray, in_size: int):
    """The taps as banded blocks: for each run of ``_BAND_OUTPUTS`` outputs
    the input span [lo, hi) its taps read and its (hi - lo, outputs) weight
    block, zero off the band."""
    n, k = weights.shape
    blocks = []
    for b0 in range(0, n, _BAND_OUTPUTS):
        b1 = min(n, b0 + _BAND_OUTPUTS)
        lo = int(start[b0])
        hi = min(in_size, int(start[b1 - 1]) + k)
        block = np.zeros((hi - lo, b1 - b0))
        for j in range(b0, b1):
            taps = weights[j][: hi - int(start[j])]
            block[int(start[j]) - lo : int(start[j]) - lo + len(taps), j - b0] = taps
        blocks.append((lo, hi, b0, b1, torch.from_numpy(block)))
    return blocks


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's two passes (``ImagingResampleHorizontal_8bpc`` or
    ``..._Vertical_8bpc``) along ``axis`` (0 or 1) of an HWC uint8 array:
    per output the taps' weighted sum from 2^21, shifted right by 22 and
    clamped. The sums run as banded block products in float64, where every
    partial sum is an integer below 2^31 and so exact in any order (a tap
    at a time over strided gathers gives the same bytes, many times slower
    on a whole layer)."""
    in_size = arr.shape[axis]
    start, weights = _bilinear_taps(in_size, out_size)
    blocks = _band_blocks(start, weights, in_size)
    src = torch.movedim(torch.from_numpy(np.asarray(arr)), axis, -1)  # (a, c, in)
    out = torch.empty(src.shape[:-1] + (out_size,), dtype=torch.uint8)
    step = max(1, _CHUNK_ELEMENTS // (src.shape[1] * in_size))
    for r in range(0, src.shape[0], step):
        seg = src[r : r + step].to(torch.float64)
        for lo, hi, b0, b1, block in blocks:
            acc = (seg[..., lo:hi] @ block).to(torch.int64) + (1 << (_PRECISION_BITS - 1))
            out[r : r + step, :, b0:b1] = (
                acc.clamp(0, (1 << _PRECISION_BITS << 8) - 1) >> _PRECISION_BITS
            ).to(torch.uint8)
    return torch.movedim(out, -1, axis).contiguous().numpy()


def _resize_uint8(arr: np.ndarray, target_hw: tuple[int, int]) -> np.ndarray:
    """Resize an HWC uint8 RGB array to ``target_hw`` as Pillow's
    ``Image.resize((w, h), BILINEAR)`` does, byte for byte: the horizontal
    pass first (on every row), then the vertical, each rounding to uint8; a
    pass whose size does not change is skipped, as Pillow skips it."""
    th, tw = int(target_hw[0]), int(target_hw[1])
    if th < 1 or tw < 1:
        raise ValueError(f"target size must be positive, got {(th, tw)}")
    out = np.asarray(arr)
    if out.shape[1] != tw:
        out = _resample_axis(out, tw, axis=1)
    if out.shape[0] != th:
        out = _resample_axis(out, th, axis=0)
    return np.ascontiguousarray(out)

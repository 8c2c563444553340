"""Slide abstraction: pyramidal gigapixel images, copied from
``deephisto_tpu/slide/base.py`` without what the port does not call: the
PIL previews (``to_image``, ``get_region``; the machine with the card has no
PIL) and ``mmap_layer``.

The reference consumes the external ``psimage`` package (PSImage objects used at
reference patch_samplers/region_samplers.py:10-11 and full_samplers.py:11-12).
This module defines the narrow surface the framework actually needs —
``layer_size``, ``get_region_from_layer``, ``height``/``width``,
context-manager protocol — so any pyramidal backend can
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

    # -- helpers ------------------------------------------------------------

    def _assert_layer(self, layer: int) -> None:
        if layer not in self.layers:
            raise ValueError(f"layer {layer} not in pyramid layers {self.layers}")

    def _layer_array(self, layer: int) -> np.ndarray:
        raise NotImplementedError

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
        pooled = (
            cur.reshape(ph // 2, 2, pw // 2, 2, 3)
            .astype(np.uint16)
            .sum(axis=(1, 3))
            // 4
        ).astype(np.uint8)
        l *= 2
        layers[l] = pooled
        cur = pooled
    return layers

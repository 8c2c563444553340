"""DHS — the on-disk pyramidal slide format of deephisto_tpu (copied from
``deephisto_tpu/slide/dhs.py``; both packages read and write the same files).

Stands in for the external ``.psi`` codec the reference depends on (reference
region_samplers.py:10, full_samplers.py:11). Layout is chosen for zero-decode
region reads: one raw ``.npy`` per pyramid layer, opened memory-mapped so a
region read touches only the pages it needs — the psimage tile-decode hot loop
(SURVEY.md §3-A "HOT LOOP 2") becomes a plain mmap slice.

Layout::

    <name>.dhs/
        meta.json      {"height": H, "width": W, "layers": [1, 2, ...]}
        L1.npy         (H, W, 3) uint8, memory-mappable
        L2.npy         layer-2 array, etc.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .base import Slide, build_pyramid

SUFFIX = ".dhs"


class DHSlide(Slide):
    """Reader for the on-disk DHS format (memory-mapped, lazy per layer)."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        meta_path = self.path / "meta.json"
        if not meta_path.is_file():
            raise FileNotFoundError(f"not a DHS slide (no meta.json): {self.path}")
        meta = json.loads(meta_path.read_text())
        self.height = int(meta["height"])
        self.width = int(meta["width"])
        self.layers = tuple(int(l) for l in meta["layers"])
        self._arrays: dict[int, np.ndarray] = {}

    def _layer_array(self, layer: int) -> np.ndarray:
        arr = self._arrays.get(layer)
        if arr is None:
            arr = np.load(self.path / f"L{layer}.npy", mmap_mode="r")
            self._arrays[layer] = arr
        return arr

    def load_layer(self, layer: int) -> np.ndarray:
        """Materialize a full layer in host RAM (contiguous uint8 copy)."""
        self._assert_layer(layer)
        return np.ascontiguousarray(self._layer_array(layer))

    def mmap_layer(self, layer: int) -> np.ndarray | None:
        """The raw memory-mapped layer, validated against meta.json (a size
        mismatch must fail loudly here rather than as an out-of-bounds read
        downstream)."""
        self._assert_layer(layer)
        arr = self._layer_array(layer)
        if not isinstance(arr, np.memmap):
            return None
        expect = self.layer_size(layer)
        if tuple(arr.shape[:2]) != expect:
            raise ValueError(
                f"DHS layer {layer} shape {arr.shape[:2]} does not match "
                f"meta.json layer size {expect} ({self.path})"
            )
        return arr

    def close(self) -> None:
        self._arrays.clear()


def write_dhs(level0: np.ndarray, path: Path | str, max_layer: int = 8) -> Path:
    """Write an HWC uint8 array as a DHS slide directory. Returns the path."""
    path = Path(path)
    if path.suffix != SUFFIX:
        path = path.with_suffix(SUFFIX)
    path.mkdir(parents=True, exist_ok=True)
    pyramid = build_pyramid(np.ascontiguousarray(level0, dtype=np.uint8), max_layer)
    for layer, arr in pyramid.items():
        np.save(path / f"L{layer}.npy", arr)
    meta = {
        "height": int(level0.shape[0]),
        "width": int(level0.shape[1]),
        "layers": sorted(pyramid.keys()),
        "format": "dhs.v1",
    }
    (path / "meta.json").write_text(json.dumps(meta))
    return path

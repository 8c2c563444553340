"""In-memory pyramidal slide backed by a numpy array (copied from
``deephisto_tpu/slide/array_slide.py``)."""

from __future__ import annotations

import numpy as np

from .base import Slide, build_pyramid


class ArraySlide(Slide):
    """A slide whose full-resolution content is a single HWC uint8 array.

    The pyramid is built eagerly by 2x2 mean pooling. Primarily used for tests,
    synthetic data, and as the decoded form of on-disk slides small enough to
    fit in host RAM.
    """

    def __init__(self, level0: np.ndarray, max_layer: int = 8):
        if level0.ndim == 2:
            level0 = np.stack([level0] * 3, axis=-1)
        level0 = np.ascontiguousarray(level0, dtype=np.uint8)
        self._pyramid = build_pyramid(level0, max_layer)
        self.height, self.width = level0.shape[:2]
        self.layers = tuple(sorted(self._pyramid.keys()))

    def _layer_array(self, layer: int) -> np.ndarray:
        return self._pyramid[layer]

"""SlideBank: slide layers staged on the card for patch gathering, a port of
``deephisto_tpu/samplers/bank.py``.

Each slide's pyramid layer is loaded once, padded to a common shape (plus the
JAX package's gather slack, so both packages gather from banks of the same
shape), and staged as one (S, Hmax, Wmax, 3) uint8 tensor on the device.
Patches are gathered from it by kernel K1's multi-slide mode.

The JAX package's host mode, for banks over the device budget, is not
ported: such a bank raises (ROADMAP, queue A item 7).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..slide import Slide, open_slide

# gather slack of the JAX package's bank (deephisto_tpu/samplers/bank.py)
SLACK_ROWS = 16
SLACK_COLS = 96


class SlideBank:
    """A set of slide layers, staged on ``device`` (the current CUDA device
    by default; ``"cpu"`` for the plain versions)."""

    def __init__(
        self,
        img_paths: list[Path | str] | list[Slide],
        layer: int,
        device=None,
        budget_bytes: int | None = 12 << 30,
    ):
        self.layer = layer
        self.device = resolve_device(device)
        arrays: list[np.ndarray] = []
        self.layer_hw: list[tuple[int, int]] = []
        for p in img_paths:
            slide = p if isinstance(p, Slide) else open_slide(p)
            with slide:
                h, w = slide.layer_size(layer)
                arrays.append(slide.get_region_from_layer(layer, (0, 0), (h, w)))
                self.layer_hw.append((h, w))

        hmax = max(a.shape[0] for a in arrays) + SLACK_ROWS
        wmax = max(a.shape[1] for a in arrays) + SLACK_COLS
        nbytes = len(arrays) * hmax * wmax * 3
        if budget_bytes is not None and nbytes > budget_bytes:
            raise ValueError(
                f"the slide bank needs {nbytes} bytes, over the device budget of "
                f"{budget_bytes}; the JAX package's host-mode bank is not ported "
                "(ROADMAP, queue A item 7)"
            )
        stack = np.zeros((len(arrays), hmax, wmax, 3), dtype=np.uint8)
        for i, a in enumerate(arrays):
            stack[i, : a.shape[0], : a.shape[1]] = a
        self.images = torch.from_numpy(stack).to(self.device)
        self.layer_hw_arr = np.asarray(self.layer_hw, dtype=np.int32)

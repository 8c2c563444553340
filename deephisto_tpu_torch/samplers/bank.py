"""SlideBank: slide layers staged for patch gathering, a port of
``deephisto_tpu/samplers/bank.py``.

Each slide's pyramid layer is loaded once, padded to a common shape (plus the
JAX package's gather slack, so both packages gather from banks of the same
shape), and staged as one (S, Hmax, Wmax, 3) uint8 tensor on the device.
Patches are gathered from it by kernel K1's multi-slide mode.

Host mode, as in the JAX package, keeps the stack in host memory as a numpy
array: taken when the stack is over ``budget_bytes`` (``budget_bytes=0``
asks for it). Its gathers slice the numpy stack (start indices clamped as
the device gather clamps them) and send the patches to the device. The JAX
package's native C++ extractor is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..ops.gather import gather_multi_u8
from ..slide import Slide, open_slide

# gather slack of the JAX package's bank (deephisto_tpu/samplers/bank.py)
SLACK_ROWS = 16
SLACK_COLS = 96


class SlideBank:
    """A set of slide layers, staged on ``device`` (the current CUDA device
    by default; ``"cpu"`` for the plain versions), or kept on the host when
    the stack is over ``budget_bytes``, its gathers then returning patches
    on ``device``."""

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
        stack = np.zeros((len(arrays), hmax, wmax, 3), dtype=np.uint8)
        for i, a in enumerate(arrays):
            stack[i, : a.shape[0], : a.shape[1]] = a
        self.on_device = budget_bytes is None or stack.nbytes <= budget_bytes
        if self.on_device:
            self.images = torch.from_numpy(stack).to(self.device)
        else:
            self.images = stack
            print(f"SlideBank layer {layer}: {stack.nbytes} bytes kept on the host (over the "
                  f"device budget of {budget_bytes}); patches are gathered there")
        self.layer_hw_arr = np.asarray(self.layer_hw, dtype=np.int32)

    @property
    def n_slides(self) -> int:
        return len(self.layer_hw)

    def gather(self, slide_idx, coords, patch_size: int) -> torch.Tensor:
        """(N, ps, ps, 3) uint8 patches across slides of the bank, on the
        bank's device: K1 on a device bank, numpy slicing on a host bank."""
        if self.on_device:
            return gather_multi_u8(self.images, torch.as_tensor(slide_idx, dtype=torch.int32),
                                   torch.as_tensor(coords, dtype=torch.int32), patch_size)
        s = torch.as_tensor(slide_idx).cpu().numpy()
        c = torch.as_tensor(coords).cpu().numpy()
        _, h, w, _ = self.images.shape
        ys = np.clip(c[:, 0], 0, h - patch_size)  # lax.dynamic_slice's clamp
        xs = np.clip(c[:, 1], 0, w - patch_size)
        out = np.empty((len(s), patch_size, patch_size, 3), dtype=np.uint8)
        for i in range(len(s)):
            out[i] = self.images[s[i], ys[i]:ys[i] + patch_size, xs[i]:xs[i] + patch_size]
        return torch.from_numpy(out).to(self.device)

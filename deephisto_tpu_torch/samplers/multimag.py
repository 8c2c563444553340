"""Multi-magnification patch pyramids, a port of
``deephisto_tpu/samplers/multimag.py``.

For every sampled patch location, co-centered patches from several pyramid
layers (e.g. 1×/2×/4×) give the classifier local detail plus context: the
multi-magnification configuration, paired with the ResNet-50 backbone.
Each layer's patches are one launch of kernel K1's multi-slide uint8 mode
over that layer's bank.

Geometry: a base-layer patch with corner ``(y, x)`` and size ``ps`` has its
full-resolution center at ``(y + ps/2) * base_layer``; the layer-``l`` patch
shares that center, covering ``l / base_layer``× the physical context.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .bank import SlideBank


class MultiMagBank:
    """Per-magnification SlideBanks over the same set of slides, on
    ``device`` (as :class:`SlideBank`)."""

    def __init__(
        self,
        img_paths: list[Path | str],
        layers: tuple[int, ...] = (1, 2, 4),
        device=None,
    ):
        self.layers = tuple(layers)
        self.banks = {l: SlideBank(img_paths, layer=l, device=device) for l in self.layers}

    def gather(self, slide_idx, coords, patch_size: int, base_layer: int) -> torch.Tensor:
        """(N, L, ps, ps, 3) uint8 co-centered patches at every magnification;
        ``coords`` are (N, 2) base-layer corner coords (y, x)."""
        ps = patch_size
        bank0 = self.banks[self.layers[0]]
        coords = torch.as_tensor(coords, dtype=torch.int32).to(bank0.device)
        slide_idx = torch.as_tensor(slide_idx, dtype=torch.int32).to(bank0.device)
        center_full = (coords.float() + ps / 2.0) * base_layer  # (N, 2), f32 as JAX
        per_layer = []
        for l in self.layers:
            bank = self.banks[l]
            corner = torch.round(center_full / l - ps / 2.0).int()
            hw = torch.from_numpy(bank.layer_hw_arr).to(corner.device)[slide_idx.long()]
            corner = torch.minimum(corner.clamp_min(0), (hw - ps).clamp_min(0))
            per_layer.append(bank.gather(slide_idx, corner, ps))
        return torch.stack(per_layer, dim=1)


def stack_mags_as_channels(patches_multimag: torch.Tensor) -> torch.Tensor:
    """(N, L, ps, ps, 3) → (N, ps, ps, 3L): magnifications concatenated on the
    channel axis, the input format of the multi-mag classifier."""
    n, L, ps, _, c = patches_multimag.shape
    return patches_multimag.permute(0, 2, 3, 1, 4).reshape(n, ps, ps, L * c)


def make_multimag_sample_fn(region_sampler, mm_bank: MultiMagBank, n: int):
    """``gen -> (patches_3L_u8, labels, coords, img_idx)`` of a device
    generator: the region sampler's coordinates with multi-magnification
    gathers; a sample source of the fused training epoch."""
    host_layers = [l for l, b in mm_bank.banks.items() if not b.on_device]
    if host_layers:
        raise ValueError(
            f"multi-mag layers {host_layers} are on the host; the multi-mag sample "
            "fn requires every magnification bank on the device (reduce the layers "
            "or raise the bank budget)"
        )
    coord_fn = region_sampler.make_sample_fn(n, gather=False)
    ps = region_sampler.patch_size
    base_layer = region_sampler.layer

    def fn(gen):
        labels, coords, img_idx = coord_fn(gen)
        patches = mm_bank.gather(img_idx, coords, ps, base_layer)
        return stack_mags_as_channels(patches), labels, coords, img_idx

    return fn

"""Preprocessing + augmentation on tensors, a port of
``deephisto_tpu/ops/augment.py``: uint8 → float ``/ 255`` and optional
random horizontal and vertical flips, drawn from an explicit
``torch.Generator`` on the batch's device (the JAX functions take a key).

Layout: NHWC, as the JAX package keeps it.
"""

from __future__ import annotations

import torch


def _coins(gen: torch.Generator, shape: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Two Bernoulli(0.5) draws of ``shape`` (horizontal, vertical)."""
    return (torch.rand(shape, generator=gen, device=device) < 0.5,
            torch.rand(shape, generator=gen, device=device) < 0.5)


def preprocess_batch(batch_u8: torch.Tensor, gen: torch.Generator | None = None,
                     augment: bool = False, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W, C) uint8 → normalized float batch, optionally flip-augmented.
    Flips are batch-wide with probability 0.5 each (one coin per batch, as
    torchvision's transforms on the stacked batch in the reference)."""
    x = batch_u8.to(dtype) / torch.tensor(255.0, dtype=dtype)
    if augment:
        if gen is None:
            raise ValueError("augment=True requires a torch.Generator")
        do_h, do_v = _coins(gen, (), x.device)
        x = torch.where(do_h, x.flip(2), x)
        x = torch.where(do_v, x.flip(1), x)
    return x


def preprocess_batch_per_sample(batch_u8: torch.Tensor, gen: torch.Generator,
                                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-sample independent h/v flips (the stronger augmentation variant)."""
    x = batch_u8.to(dtype) / torch.tensor(255.0, dtype=dtype)
    do_h, do_v = _coins(gen, (x.shape[0],), x.device)
    x = torch.where(do_h[:, None, None, None], x.flip(2), x)
    return torch.where(do_v[:, None, None, None], x.flip(1), x)

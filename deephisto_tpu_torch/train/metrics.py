"""Training metrics, a port of ``deephisto_tpu/train/metrics.py``: they stay
on the device, so a training loop reads them back once per epoch."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean CE over the batch. ``label_smoothing`` > 0 mixes the one-hot
    target with the uniform distribution, ``onehot·(1-ε) + ε/K`` (optax's
    smoothed targets, and torch's); 0.0 keeps the plain CE."""
    return F.cross_entropy(logits.float(), labels.long(), label_smoothing=label_smoothing)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()

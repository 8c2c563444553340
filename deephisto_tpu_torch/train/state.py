"""Train state and the learning-rate schedules, a port of
``deephisto_tpu/train/state.py``.

The JAX package trains with optax ``inject_hyperparams(adam)``, or
``adamw`` when ``weight_decay`` > 0, with their defaults (b1 0.9, b2 0.999,
eps 1e-8, decay on every parameter). The port uses ``torch.optim.Adam`` and
``AdamW`` with the same hyperparameters: the same update, rounded in
another order. The learning rate is the optimizer's ``lr``, set from the
host between epochs (:func:`set_learning_rate`). The schedules are plain
Python, copied.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), its optimizer and
    the number of optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(
    model: nn.Module,
    learning_rate: float,
    tx: torch.optim.Optimizer | None = None,
    weight_decay: float = 0.0,
) -> TrainState:
    """Adam by default (the reference's optimizer); AdamW when
    ``weight_decay`` > 0 (the standard ViT recipe); or the optimizer ``tx``
    over the model's parameters."""
    if tx is None:
        params = list(model.parameters())
        if weight_decay > 0.0:
            tx = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=weight_decay)
        else:
            tx = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=tx)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Write the learning rate of every parameter group (host-side, cheap)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min'):
    after ``patience`` epochs without improvement beyond ``threshold``,
    multiply the LR by ``factor`` (not below ``min_lr``)."""

    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 5,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        assert mode in ("min", "max")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: float | None = None
        self.num_bad_epochs = 0

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(value):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def get_last_lr(self) -> list[float]:
        return [self.lr]


class WarmupCosine:
    """Per-epoch linear-warmup + cosine-decay LR controller (the standard ViT
    training schedule). Same ``.step(metric) -> lr`` surface as
    :class:`ReduceLROnPlateau` so the trainer can swap schedules from config;
    the metric argument is ignored."""

    def __init__(
        self,
        lr: float,
        total_epochs: int,
        warmup_epochs: int = 3,
        min_lr: float = 0.0,
    ):
        self.base = lr
        self.total = total_epochs
        self.warmup = min(warmup_epochs, total_epochs)
        self.min_lr = min_lr
        self.epoch = 0
        self.lr = self._at(0)

    def _at(self, e: int) -> float:
        import math

        if self.warmup > 0 and e < self.warmup:
            return self.base * (e + 1) / self.warmup
        # decay spans [warmup, total-1] so the FINAL epoch runs at min_lr
        t = (e - self.warmup) / max(1, self.total - 1 - self.warmup)
        t = min(max(t, 0.0), 1.0)
        return self.min_lr + (self.base - self.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * t)
        )

    def step(self, value: float | None = None) -> float:
        self.epoch += 1
        self.lr = self._at(self.epoch)
        return self.lr

    def get_last_lr(self) -> list[float]:
        return [self.lr]


def make_scheduler(cfg_training: dict):
    """Build the LR controller from the training config section.

    ``schedule: plateau`` (default — the reference's ReduceLROnPlateau,
    train.py:118-122) or ``schedule: warmup_cosine`` with ``warmup_epochs`` /
    ``min_lr`` (the ViT recipe)."""
    kind = cfg_training.get("schedule", "plateau")
    lr = cfg_training["lr"]
    if kind == "plateau":
        return ReduceLROnPlateau(lr=lr, mode="min", factor=0.1, patience=5)
    if kind == "warmup_cosine":
        return WarmupCosine(
            lr=lr,
            total_epochs=cfg_training["n_epochs"],
            warmup_epochs=cfg_training.get("warmup_epochs", 3),
            min_lr=cfg_training.get("min_lr", 0.0),
        )
    raise ValueError(f"unknown training.schedule: {kind!r}")

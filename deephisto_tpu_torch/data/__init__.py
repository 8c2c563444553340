"""Synthetic dataset materialization."""

from .synthetic_dataset import ensure_synthetic_dataset

__all__ = ["ensure_synthetic_dataset"]

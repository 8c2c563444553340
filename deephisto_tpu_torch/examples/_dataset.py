"""Shared example-dataset resolution (as ``examples/_dataset.py``): the
dataset root comes from ``$DEEPHISTO_DATASET`` (or ./data/synthetic_wss),
and a synthetic dataset is materialized there on first use, so every
example runs with zero setup."""

import os
from pathlib import Path

from ..utils import resolve_dataset


def example_dataset() -> Path:
    root = Path(os.environ.get("DEEPHISTO_DATASET", "./data/synthetic_wss"))
    return resolve_dataset(root)

"""Device resolution for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device. Raises when CUDA is asked for
    (explicitly or by default) and no card is present: the CPU runs only
    the plain PyTorch versions, and only when the caller says so."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        if device is None or torch.device(device).index is None:
            return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)

"""Model export for serving, a port of ``deephisto_tpu/export.py``: the
trained classifier's inference program, ``uint8 patches (B, ps, ps, 3) →
logits (B, C)`` with the /255 normalization and the weights baked in, traced
by ``torch.export`` at a static batch and saved as a ``.pt2`` artifact
(where the JAX package writes StableHLO). A process loads it and runs it
without the model's Python source: only the port's registered ops
(``deephisto::flash_attention`` for K3, ``deephisto::conv_int8*`` for K6)
must be importable, and :func:`load_classifier` imports them.

It takes the ResNet and ViT families (K3 from ``FLASH_MIN_SEQ`` tokens up)
and the int8 ``QuantizedResNet`` and ``QuantizedViT``. On the card the
loaded program launches K3 and K6 through those ops; on the CPU their plain
versions run.
"""

from __future__ import annotations

import io
from pathlib import Path

import torch
from torch import nn

from ._device import resolve_device

SUFFIX = ".pt2"


class Classifier(nn.Module):
    """``uint8 (B, ps, ps, 3) → logits``: the bytes /255 in ``dtype``, then
    ``model``. A model that takes the raw bytes (``wants_uint8``: the int8
    models, whose input quantize folds the /255, as the predicts feed them)
    gets them as they are."""

    def __init__(self, model: nn.Module, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, patches_u8: torch.Tensor) -> torch.Tensor:
        if getattr(self.model, "wants_uint8", False):
            return self.model(patches_u8)
        return self.model(patches_u8.to(self.dtype) / 255.0)


def export_classifier(
    model: nn.Module,
    batch_size: int,
    patch_size: int,
    path: Path | str | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> bytes:
    """Serialize ``uint8 patches (B, ps, ps, 3) -> logits (B, C)`` of
    ``model`` (in eval mode, with its weights) traced on ``device`` (the
    current CUDA device by default; ``"cpu"`` to export there). Returns the
    bytes; writes them when ``path`` is given (suffix ``.pt2``)."""
    dev = resolve_device(device)
    wrapper = Classifier(model.eval(), dtype)
    example = torch.zeros((batch_size, patch_size, patch_size, 3), dtype=torch.uint8,
                          device=dev)
    with torch.no_grad():
        program = torch.export.export(wrapper, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        path = Path(path)
        if path.suffix != SUFFIX:
            path = path.with_suffix(SUFFIX)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    return data


def load_classifier(path_or_bytes) -> nn.Module:
    """Load an exported classifier; returns a module ``fn(patches_u8) ->
    logits`` (``ExportedProgram.module()``, its weights frozen: an inference
    program) on the device it was exported on."""
    from .ops import attention, conv_int8  # noqa: F401  (registers the ops)

    data = (
        bytes(path_or_bytes)
        if isinstance(path_or_bytes, (bytes, bytearray))
        else Path(path_or_bytes).read_bytes()
    )
    return torch.export.load(io.BytesIO(data)).module().requires_grad_(False)

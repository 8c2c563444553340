"""Exact dense full-WSI prediction, a port of
``deephisto_tpu/predict/pipeline.py`` (``dense_coords``, ``model_input``,
``predict_full_fused``).

The JAX package runs the whole predict as one ``lax.scan``; here a Python
loop over coordinate batches launches, per batch, K1 (gather + /255 to
bf16), the model, an optional softmax and K2 (stitch), all queued on the
current stream without waiting for the card. The host reads back only the
final argmax map.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.gather import gather_normalize
from ..ops.stitch import scatter_add_map_exact


def model_input(model, patches_u8: torch.Tensor) -> torch.Tensor:
    """uint8 patches → what the model takes: ``bf16(u8) / bf16(255)`` for
    float models (as predict/pipeline.py:42; an f32 model casts the bf16
    values up), raw uint8 for models that declare ``wants_uint8``."""
    if getattr(model, "wants_uint8", False):
        return patches_u8
    return patches_u8.to(torch.bfloat16) / torch.tensor(
        255.0, dtype=torch.bfloat16, device=patches_u8.device
    )


def dense_coords(h: int, w: int, patch_size: int, stride: int) -> np.ndarray:
    """The dense tiling coord list (grid + last col/row + corner — same cover
    rule as FullImageDenseSampler / reference full_samplers.py:374-397)."""
    ps = patch_size
    if h < ps or w < ps:
        raise ValueError(
            f"layer size {(h, w)} is smaller than patch_size {ps}; choose a "
            "lower pyramid layer or a smaller patch"
        )
    coords = [(y, x) for y in range(0, h - ps, stride) for x in range(0, w - ps, stride)]
    coords += [(y, w - ps) for y in range(0, h - ps, stride)]
    coords += [(h - ps, x) for x in range(0, w - ps, stride)]
    coords.append((h - ps, w - ps))
    return np.asarray(coords, dtype=np.int32)


def predict_full_fused(
    image,
    model,
    n_classes: int,
    patch_size: int = 224,
    stride: int = 112,
    batch_size: int = 256,
    downscale: int = 16,
    softmax: bool = False,
    device=None,
):
    """Dense full-WSI prediction; returns (argmax_map, score_map).

    image: (H, W, 3) uint8, numpy or a tensor (kept where it is if already on
    ``device``). model: a float model (ResNet or ViT) on ``device``; it is
    put in eval mode. A model that declares ``wants_uint8`` is refused: K1
    writes bf16 u8/255 only.
    device: None runs on the current CUDA device and raises without one;
    ``"cpu"`` runs the plain versions of the kernels.

    argmax_map is an (H/d, W/d) uint8 numpy array (first maximum on ties);
    score_map the (H/d, W/d, n_classes) float32 tensor on ``device``. The
    coords are padded to whole batches by repeating the last one, and only
    the real patches of the last batch are stitched, so every tile counts
    exactly once (as the zero-weighted lanes at pipeline.py:168).
    """
    if n_classes > 255:
        raise ValueError("class maps are uint8: n_classes must be <= 255")
    if getattr(model, "wants_uint8", False):
        raise ValueError(
            "the model wants raw uint8 patches (wants_uint8), but this predict "
            "feeds bf16 u8/255: K1 has no uint8 output yet (ROADMAP, queue B, B1)"
        )
    device = resolve_device(device)
    image = torch.as_tensor(image).to(device)
    if image.dtype != torch.uint8 or image.ndim != 3:
        raise ValueError(
            f"image must be (H, W, C) uint8, got {tuple(image.shape)} {image.dtype}"
        )
    image = image.contiguous()
    p = next(model.parameters())
    if p.device != device:
        raise ValueError(
            f"model is on {p.device}, the prediction on {device}; move it with "
            "model.to(device)"
        )
    h, w = int(image.shape[0]), int(image.shape[1])
    ps, bs, d = patch_size, batch_size, downscale
    coords = dense_coords(h, w, ps, stride)
    n = len(coords)
    n_b = -(-n // bs)
    if n_b * bs > n:
        coords = np.concatenate([coords, np.repeat(coords[-1:], n_b * bs - n, axis=0)])
    coords = torch.from_numpy(coords)
    if device.type == "cuda":
        coords = coords.pin_memory()  # lets every batch's upload run ahead

    model.eval()
    score_map = torch.zeros((h // d, w // d, n_classes), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for b in range(n_b):
            cb = coords[b * bs : (b + 1) * bs]
            logits = model(gather_normalize(image, cb, ps, torch.bfloat16))
            if softmax:
                logits = torch.softmax(logits.float(), dim=-1)
            real = min(bs, n - b * bs)
            scatter_add_map_exact(score_map, cb[:real], logits[:real], ps, d)
        argmax_map = score_map.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return argmax_map, score_map

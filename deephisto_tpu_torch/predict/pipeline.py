"""Exact dense full-WSI prediction, a port of
``deephisto_tpu/predict/pipeline.py`` (``dense_coords``, ``model_input``,
``PackedSlide``, ``stage_packed_slide``, ``predict_full_fused``).

The JAX package runs the whole predict as one ``lax.scan``; here a Python
loop over coordinate batches launches, per batch, K1, the model, an optional
softmax and K2 (stitch), all queued on the current stream without waiting
for the card. The host reads back only the final argmax map.

K1 runs in the mode the model takes: gather + /255 to bf16 for a float
model; for the int8 ResNet (which holds an ``input_lut``) its int8 mode, on
a one-slide view of the slide, which quantizes every byte and writes the
windows in the layout the model's stem takes (``input_layout``), so the
model gets int8 and quantizes nothing; the uint8 gather for any other model
that declares ``wants_uint8``. A :class:`PackedSlide` is gathered in its 4×4
space-to-depth units (coords and patch size divided by 4, 48 channels),
which K1 takes in every mode.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.gather import gather_multi_u8, gather_normalize, gather_quantize_int8
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


class PackedSlide:
    """A slide staged for repeated s2d-stem dense prediction: rounded up to a
    multiple of 4 (edge pad) and 4×4 space-to-depth packed, uint8 on the
    device (``packed``, (H/4, W/4, 48)); ``h``, ``w`` the slide's extent and
    ``raw`` the unpacked slide if kept. Build it with
    :func:`stage_packed_slide`; :func:`predict_full_fused` takes it in place
    of the raw image, with bit-identical results (packing commutes with
    slicing). A grid that is not 4-aligned falls back to ``raw``."""

    __slots__ = ("packed", "h", "w", "raw")

    def __init__(self, packed, h, w, raw=None):
        self.packed = packed
        self.h, self.w = h, w
        self.raw = raw


def stage_packed_slide(image, keep_raw: bool = True, device=None) -> PackedSlide:
    """Stage a slide for s2d-stem dense prediction (:class:`PackedSlide`).
    A numpy slide is padded and packed on the host, then uploaded; a tensor
    is packed where it lies (moved to ``device`` first). ``keep_raw=False``
    drops the raw slide, and a misaligned grid then raises."""
    from .fcn import _host_pack_s2d, s2d_pack_image

    device = resolve_device(device)
    h, w = int(image.shape[0]), int(image.shape[1])
    if isinstance(image, np.ndarray):
        padded = np.pad(image, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
        packed = torch.from_numpy(_host_pack_s2d(padded)).to(device)
        raw = torch.from_numpy(image).to(device) if keep_raw else None
    else:
        raw = image.to(device)
        packed = s2d_pack_image(edge_pad(raw, (0, -h % 4), (0, -w % 4)))
        raw = raw if keep_raw else None
    return PackedSlide(packed, h, w, raw=raw)


def edge_pad(image: torch.Tensor, pad_y, pad_x) -> torch.Tensor:
    """(H, W, C) → edge-replicated padding by (top, bottom) rows and (left,
    right) columns, as ``np.pad(mode="edge")``: a gather of clamped rows and
    columns, for any dtype."""
    h, w = image.shape[:2]
    if not any(pad_y) and not any(pad_x):
        return image
    dev = image.device
    rows = torch.arange(-pad_y[0], h + pad_y[1], device=dev).clamp(0, h - 1)
    cols = torch.arange(-pad_x[0], w + pad_x[1], device=dev).clamp(0, w - 1)
    return image.index_select(0, rows).index_select(1, cols)


def model_device(model) -> torch.device:
    """The device of a model's first parameter, or of its first buffer (the
    int8 ResNet holds buffers only)."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    raise ValueError("the model holds no tensor")


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
    ``device``), or a :class:`PackedSlide` for a model with the s2d stem.
    model: a float model (ResNet or ViT) or the int8 ResNet (``input_lut``)
    on ``device``; it is put in eval mode.
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
    device = resolve_device(device)
    packed = isinstance(image, PackedSlide)
    if packed:
        if getattr(model, "stem", None) != "s2d":
            raise ValueError(
                "PackedSlide is the s2d-packed representation; the model "
                f"has stem={getattr(model, 'stem', None)!r}"
            )
        h, w = image.h, image.w
    else:
        image = torch.as_tensor(image).to(device)
        if image.dtype != torch.uint8 or image.ndim != 3:
            raise ValueError(
                f"image must be (H, W, C) uint8, got {tuple(image.shape)} {image.dtype}"
            )
        h, w = int(image.shape[0]), int(image.shape[1])
    if model_device(model) != device:
        raise ValueError(
            f"model is on {model_device(model)}, the prediction on {device}; move it with "
            "model.to(device)"
        )
    ps, bs, d = patch_size, batch_size, downscale
    coords = dense_coords(h, w, ps, stride)
    if packed and (ps % 4 or (coords % 4).any()):
        if image.raw is None:
            raise ValueError(
                "PackedSlide prediction needs 4-aligned patch_size and coords "
                f"(patch_size={ps}, stride={stride}); stage with keep_raw=True or pass "
                "the raw image for arbitrary grids"
            )
        image, packed = image.raw, False
    slide = (image.packed if packed else image).to(device).contiguous()
    unit = 4 if packed else 1
    n = len(coords)
    n_b = -(-n // bs)
    if n_b * bs > n:
        coords = np.concatenate([coords, np.repeat(coords[-1:], n_b * bs - n, axis=0)])
    coords = torch.from_numpy(coords)
    if device.type == "cuda":
        coords = coords.pin_memory()  # lets every batch's upload run ahead

    lut = getattr(model, "input_lut", None)
    wants_uint8 = getattr(model, "wants_uint8", False)
    one_slide = torch.zeros((bs,), dtype=torch.int32, device=device)
    kwargs = {"pre_packed": True} if packed else {}
    if lut is not None:
        layout, pre_packed = model.input_layout(packed)
        kwargs = {"pre_packed": pre_packed} if pre_packed else {}
    model.eval()
    score_map = torch.zeros((h // d, w // d, n_classes), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for b in range(n_b):
            cb = coords[b * bs : (b + 1) * bs]
            cg = cb // unit if packed else cb
            if lut is not None:  # K1's int8 mode on a one-slide view of the slide
                x = gather_quantize_int8(slide[None], one_slide, cg, ps // unit, lut, layout)
            elif wants_uint8:  # K1's uint8 mode
                x = gather_multi_u8(slide[None], one_slide, cg, ps // unit)
            else:
                x = gather_normalize(slide, cg, ps // unit, torch.bfloat16)
            logits = model(x, **kwargs)
            if softmax:
                logits = torch.softmax(logits.float(), dim=-1)
            real = min(bs, n - b * bs)
            scatter_add_map_exact(score_map, cb[:real], logits[:real], ps, d)
        argmax_map = score_map.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return argmax_map, score_map

"""Exact dense and coverage-random full-WSI prediction, a port of
``deephisto_tpu/predict/pipeline.py`` (``dense_coords``, ``model_input``,
``PackedSlide``, ``stage_packed_slide``, ``predict_full_fused``,
``predict_full_random_fused``).

The JAX package runs the whole predict as one ``lax.scan``; here a Python
loop over coordinate batches launches, per batch, K1, the model, an optional
softmax and K2 (stitch), all queued on the current stream without waiting
for the card. The host reads back only the final argmax map.

K1 runs in the mode the model takes: gather + /255 to bf16 for a float
model; for an int8 model (the int8 ResNet or ViT, which hold an
``input_lut``) its int8 mode, on a one-slide view of the slide, which
quantizes every byte and writes the windows in the layout the model's stem
takes (``input_layout``), so the model gets int8 and quantizes nothing; the
uint8 gather for any other model that declares ``wants_uint8`` (the
folded-stem ViT). A :class:`PackedSlide` is gathered in its 4×4
space-to-depth units (coords and patch size divided by 4, 48 channels),
which K1 takes in every mode.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.gather import gather_multi_u8, gather_normalize, gather_quantize_int8
from ..ops.stitch import accumulate_coverage, coverage_footprint, scatter_add_map_exact
from ..profiling import blocking_copy, span
from ..samplers.full import max_coverage_steps, rnd_coords
from .ingest import upload_slide


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


def model_tokens(model) -> dict:
    """``{"tokens": n}``, the tokens a patch carries through a
    transformer's blocks (``n_tokens``: 784 for ViT-S/8, 265 for UNI2-h);
    empty for a model without tokens."""
    n = getattr(model, "n_tokens", None)
    return {"tokens": int(n)} if n else {}


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


def _checked_inputs(image, model, n_classes: int, device: torch.device):
    """Check a predict's slide, model and class count → (image, packed, h,
    w): the image a PackedSlide or an (H, W, C) uint8 tensor on
    ``device``."""
    if n_classes > 255:
        raise ValueError("class maps are uint8: n_classes must be <= 255")
    packed = isinstance(image, PackedSlide)
    if packed:
        if getattr(model, "stem", None) != "s2d":
            raise ValueError(
                "PackedSlide is the s2d-packed representation; the model "
                f"has stem={getattr(model, 'stem', None)!r}"
            )
        h, w = image.h, image.w
    else:
        image = upload_slide(image, device)
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
    return image, packed, h, w


class BatchPredictor:
    """The per-batch body of both full-WSI predicts: K1 in the mode the
    model takes (float /255 to bf16; the int8 ResNet's int8 mode, in its
    stem's layout; uint8 for another ``wants_uint8`` model), the forward,
    an optional softmax, then K2 into the score map. ``slide`` is the raw
    (H, W, C) uint8 slide or, with ``packed``, the PackedSlide; the model
    is put in eval mode."""

    def __init__(self, slide, packed: bool, model, patch_size: int, downscale: int,
                 batch_size: int, device: torch.device, softmax: bool = False):
        self.slide = (slide.packed if packed else slide).to(device).contiguous()
        self.unit = 4 if packed else 1
        self.model, self.ps, self.d, self.softmax = model, patch_size, downscale, softmax
        self.lut = getattr(model, "input_lut", None)
        self.wants_uint8 = getattr(model, "wants_uint8", False)
        self.one_slide = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        self.kwargs = {"pre_packed": True} if packed else {}
        if self.lut is not None:
            self.layout, pre_packed = model.input_layout(packed)
            self.kwargs = {"pre_packed": pre_packed} if pre_packed else {}
        model.eval()

    def __call__(self, score_map: torch.Tensor, coords: torch.Tensor, real: int) -> None:
        """Add the scores of the first ``real`` patches at raw (N, 2) int32
        ``coords`` into ``score_map``."""
        logits = self.logits(coords)
        scatter_add_map_exact(score_map, coords[:real], logits[:real], self.ps, self.d)

    def logits(self, coords: torch.Tensor) -> torch.Tensor:
        """K1 and the forward (and the softmax) of the patches at raw (N, 2)
        int32 ``coords`` of the slide: (N, n_classes) scores."""
        cg = coords // self.unit if self.unit > 1 else coords
        ps = self.ps // self.unit
        if self.lut is not None:  # K1's int8 mode on a one-slide view of the slide
            x = gather_quantize_int8(self.slide[None], self.one_slide[: len(cg)], cg, ps,
                                     self.lut, self.layout)
        elif self.wants_uint8:  # K1's uint8 mode
            x = gather_multi_u8(self.slide[None], self.one_slide[: len(cg)], cg, ps)
        else:
            x = gather_normalize(self.slide, cg, ps, torch.bfloat16)
        logits = self.model(x, **self.kwargs)
        if self.softmax:
            logits = torch.softmax(logits.float(), dim=-1)
        return logits


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
    mesh=None,
):
    """Dense full-WSI prediction; returns (argmax_map, score_map).

    image: (H, W, 3) uint8, numpy or a tensor (kept where it is if already on
    ``device``), or a :class:`PackedSlide` for a model with the s2d stem.
    model: a float model (ResNet or ViT, or the folded-stem ViT) or an int8
    model (``input_lut``: the int8 ResNet or ViT) on ``device``; it is put
    in eval mode.
    device: None runs on the current CUDA device and raises without one;
    ``"cpu"`` runs the plain versions of the kernels.

    argmax_map is an (H/d, W/d) uint8 numpy array (first maximum on ties);
    score_map the (H/d, W/d, n_classes) float32 tensor on ``device``. The
    coords are padded to whole batches by repeating the last one, and only
    the real patches of the last batch are stitched, so every tile counts
    exactly once (as the zero-weighted lanes at pipeline.py:168).

    mesh: a ``parallel.make_mesh`` mesh, every rank calling with the same
    arguments: rank r of the ``data`` axis takes its lanes of every batch
    (``batch_size`` must divide over the axis) and runs K1, the model and K2
    into its own map, its padded lanes unstitched; one all-reduce sums the
    maps before the argmax, so every rank returns the same maps. At one rank
    they are the single predict's bit for bit; over more ranks a cell's
    patches are summed in another order (pipeline.py:133-147 shards each
    batch's coordinates over ``data`` the same way).
    """
    device = resolve_device(device)
    image, packed, h, w = _checked_inputs(image, model, n_classes, device)
    ps, bs, d = patch_size, batch_size, downscale
    with span("predict.prepare") as prepare:
        coords = dense_coords(h, w, ps, stride)
        if packed and (ps % 4 or (coords % 4).any()):
            if image.raw is None:
                raise ValueError(
                    "PackedSlide prediction needs 4-aligned patch_size and coords "
                    f"(patch_size={ps}, stride={stride}); stage with keep_raw=True or pass "
                    "the raw image for arbitrary grids"
                )
            image, packed = image.raw, False
        n = len(coords)
        prepare["coords"] = n
        n_b = -(-n // bs)
        if n_b * bs > n:
            coords = np.concatenate([coords, np.repeat(coords[-1:], n_b * bs - n, axis=0)])
        coords = torch.from_numpy(coords)
        if device.type == "cuda":
            coords = coords.pin_memory()  # lets every batch's upload run ahead

        lanes = slice(0, bs)
        if mesh is not None:
            from ..parallel.mesh import batch_sharding

            shard = batch_sharding(mesh)
            lanes = shard.rows(bs)

        step = BatchPredictor(image, packed, model, ps, d, bs, device, softmax)
        score_map = torch.zeros((h // d, w // d, n_classes), dtype=torch.float32, device=device)
    with torch.inference_mode():
        with span("predict.enqueue", batches=n_b, **model_tokens(model)):
            for b in range(n_b):
                real = min(bs, n - b * bs) - lanes.start  # this rank's real lanes
                if real > 0:
                    cb = coords[b * bs + lanes.start : b * bs + lanes.stop]
                    step(score_map, cb, min(real, len(cb)))
            if mesh is not None:
                from ..parallel._comm import all_reduce_

                all_reduce_(score_map, shard.group)
        argmax_map = blocking_copy(score_map.argmax(dim=-1).to(torch.uint8), "cpu",
                                   "predict.readback").numpy()
    return argmax_map, score_map


def predict_full_random_fused(
    image,
    model,
    n_classes: int,
    patch_size: int = 224,
    batch_size: int = 512,
    downscale: int = 16,
    speedup: int = 16,
    dense_level: int = 2,
    seed: int = 0,
    max_steps: int | None = None,
    device=None,
):
    """Coverage-guided random full-WSI prediction (pipeline.py:185-316):
    steps of a Gumbel-top-k cell draw, a jitter, K1, the forward and K2
    into the class-score map and (K2) into the coverage accumulator, until
    every accumulator cell is covered or ``max_steps``. Returns (argmax_map,
    score_map, coverage, filled, steps) as the JAX function does: the
    uint8 map (numpy), the score tensor on ``device``, the (H/speedup,
    W/speedup) coverage (numpy), its filled ratio and the steps taken.

    The JAX ``lax.while_loop`` stops after the first step whose filled
    ratio reaches 1.0, or at ``max_steps``. Here the host reads the filled
    ratio after every step (one sync a batch) and stops on the same rule,
    so steps, filled, coverage and scores are the while loop's. The draws
    come from a ``torch.Generator`` seeded with ``seed`` on ``device``.

    Takes the models and slides :func:`predict_full_fused` takes; a
    :class:`PackedSlide` (s2d-stem models) gathers in packed space with the
    jitter drawn on the 4-px grid (4-aligned patch_size and speedup)."""
    device = resolve_device(device)
    image, packed, h, w = _checked_inputs(image, model, n_classes, device)
    if packed and (patch_size % 4 or speedup % 4):
        raise ValueError(
            "PackedSlide random predict needs 4-aligned patch_size and "
            f"speedup (got {patch_size}, {speedup})"
        )
    ps, bs = patch_size, batch_size
    if h < ps or w < ps:
        raise ValueError(f"layer size {(h, w)} is smaller than patch_size {ps}")
    dh, dw = h // speedup, w // speedup
    if max_steps is None:
        max_steps = max_coverage_steps(dh, dw, bs, ps, speedup, dense_level)
    gen = torch.Generator(device=device).manual_seed(seed)
    step = BatchPredictor(image, packed, model, ps, downscale, bs, device)
    f_cov = coverage_footprint(ps, speedup)
    score_map = torch.zeros((h // downscale, w // downscale, n_classes), dtype=torch.float32,
                            device=device)
    accum = torch.zeros((dh, dw, 1), dtype=torch.float32, device=device)
    filled, steps = 0.0, 0
    with torch.inference_mode():
        while steps < max_steps and filled < 1.0:
            coords = rnd_coords(gen, accum, h, w, bs, ps, speedup, dense_level,
                                grid=4 if packed else 1)
            step(score_map, coords, bs)
            accum, fr = accumulate_coverage(accum, coords // speedup, f_cov)
            filled, steps = float(fr), steps + 1
        argmax_map = score_map.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return argmax_map, score_map, accum[..., 0].cpu().numpy(), filled, steps

"""Overlap-free fully-convolutional full-WSI prediction ("fcn" mode), a port
of ``deephisto_tpu/predict/fcn.py``.

The backbone runs once per pixel over large tiles (with a halo of real or
edge-replicated context), giving a stride-32 feature map F of the slide;
every 32-aligned 224-window's logits are recovered from F exactly, since GAP
and the fc head are linear: ``window_logits(k) = fc(mean_7x7(F[k:k+7]))``.
The class map holds, per map cell, the average of the logits of the windows
that cover it (an average, not the exact path's sum: the argmax is the same
for either, since every class of a cell has the same window count). Cells
past the last 32-aligned window replicate the last covered cell. It is a
documented non-exact mode next to the exact stride-112 path; its
``patches/s`` counts the exact path's patches (:func:`fcn_equivalent_patches`).

The JAX package runs one jitted program with a ``lax.scan`` over tile
batches; here a Python loop launches, per step of ``tile_batch`` tiles, the
tile gather (for the int8 ResNet K1's int8 mode, which quantizes the tiles
and writes them in its stem's layout), the backbone (the int8 ResNet's
convs are kernel K6), the halo crop and the fc projection, all queued on
the current stream; the host reads back only the final argmax map. The window pool and the ensemble
(B6) are torch ops. ``scan_unroll`` and ``scan_prefetch`` are accepted and
change nothing: the JAX package measured both neutral and bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.gather import gather_quantize_int8, s2d_pack4
from ..profiling import blocking_copy, span
from .ingest import upload_slide
from .pipeline import dense_coords, edge_pad, model_device, model_input

FEATURE_STRIDE = 32  # ResNet total stride: stem /4 x stage strides 1,2,2,2


def check_uint8_classes(n_classes: int) -> None:
    """Class maps travel as uint8: refuse class counts that would wrap."""
    if n_classes > 255:
        raise ValueError("class maps are uint8: n_classes must be <= 255")


def _avg_pool_f32(x: torch.Tensor, span: int) -> torch.Tensor:
    """VALID sum-pool of span × span (stride 1) over the first two axes of
    (fh, fw, C), in f32, then / span² (fcn.py:52): two separable window sums."""
    s = x.float().unfold(0, span, 1).sum(-1)
    s = s.unfold(1, span, 1).sum(-1)
    return s / float(span * span)


def _window_ensemble(wlog, wf: int, up: int, ky: int, kx: int, mh: int, mw: int):
    """Per-map-cell average of the logits of every 32-aligned window covering
    the cell (fcn.py:67): a count-normalized trailing pool of span ``wf``
    over the (ky, kx, n_classes) window logits, tail cells replicating the
    last covered one, repeat-upsampled by ``up`` to (mh, mw). Returns
    (uint8 argmax map, f32 score map)."""
    iy = -(-mh // up)
    ix = -(-mw // up)

    def trail(a, n_out, k_valid):
        pad_back = max(0, n_out - k_valid)
        ap = torch.nn.functional.pad(a, (0, 0, 0, 0, wf - 1, pad_back))
        s = ap.unfold(0, wf, 1).sum(-1)[:n_out]
        ones = torch.zeros(ap.shape[0], dtype=a.dtype, device=a.device)
        ones[wf - 1 : wf - 1 + k_valid] = 1.0
        cnt = ones.unfold(0, wf, 1).sum(-1)[:n_out]
        return s / torch.clamp(cnt, min=1.0)[:, None, None]

    a = trail(wlog, iy, ky)
    a = trail(a.transpose(0, 1), ix, kx).transpose(0, 1)  # (iy, ix, n_classes)
    dev = a.device
    idx_y = torch.clamp(torch.arange(iy, device=dev), max=ky + wf - 2)
    idx_x = torch.clamp(torch.arange(ix, device=dev), max=kx + wf - 2)
    a = a[idx_y][:, idx_x]
    score = a.repeat_interleave(up, 0).repeat_interleave(up, 1)[:mh, :mw]
    return score.argmax(dim=-1).to(torch.uint8), score


def s2d_pack_image(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → the 4×4 space-to-depth form (H/4, W/4, 16C), channel
    (ry·4 + rx)·C + c, the s2d stem's order (fcn.py:152)."""
    return s2d_pack4(image[None])[0].contiguous()


def _host_pack_s2d(a: np.ndarray, pack: int = 4) -> np.ndarray:
    """numpy 4x4 s2d pack (same channel order as s2d_pack_image); pack=8 adds
    one more 2x2 grouping on top (channel = (si*2+sj)*48 + c4x4), the
    representation ``pre_packed="s2d8"`` takes (fcn.py:181)."""
    h, w, c = a.shape
    p4 = np.ascontiguousarray(
        a.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
    ).reshape(h // 4, w // 4, 16 * c)
    if pack == 4:
        return p4
    assert pack == 8, pack
    h4, w4, c4 = p4.shape
    return np.ascontiguousarray(
        p4.reshape(h4 // 2, 2, w4 // 2, 2, c4).transpose(0, 2, 1, 3, 4)
    ).reshape(h4 // 2, w4 // 2, 4 * c4)


def _pack2_device(p4: torch.Tensor) -> torch.Tensor:
    """2×2 grouping of a 4×4-packed image → the pack=8 layout of
    :func:`_host_pack_s2d` (fcn.py:204)."""
    h4, w4, c4 = p4.shape
    x = p4.reshape(h4 // 2, 2, w4 // 2, 2, c4).permute(0, 2, 1, 3, 4)
    return x.reshape(h4 // 2, w4 // 2, 4 * c4).contiguous()


class FcnStagedSlide:
    """A slide staged for repeated fcn prediction: edge-padded to the
    (tile, halo) grid and space-to-depth packed (``pack`` 4 or 8), uint8 on
    the device; with ``pre_tile`` also (or only) the halo-overlapped tile
    grid as one contiguous (n_tiles, T', T', C) tensor ``tiles``
    (T' = (tile + 2·halo)/pack), which the predict reads one block a tile.
    Results are bit-identical to the raw-image call (fcn.py:217)."""

    __slots__ = ("packed", "h", "w", "tile", "halo", "pack", "tiles")

    def __init__(self, packed, h, w, tile, halo, pack=4, tiles=None):
        self.packed = packed
        self.h, self.w = h, w
        self.tile, self.halo = tile, halo
        self.pack = pack
        self.tiles = tiles


def _grid(h: int, w: int, tile: int, halo: int):
    ty, tx = -(-h // tile), -(-w // tile)
    return ty, tx, (halo, ty * tile - h + halo), (halo, tx * tile - w + halo)


def stage_for_fcn(image, tile: int = 1024, halo: int = 64, pack: int = 4,
                  pre_tile: bool = False, device=None) -> FcnStagedSlide:
    """Stage a slide for s2d-stem fcn serving (fcn.py:248). ``image``: (H, W,
    C) uint8, numpy (padded and packed on the host, then uploaded: the
    ingest path) or a tensor (packed on ``device``). tile/halo must match
    the predict_full_fcn call. pack=8 is the "s2d8" representation for
    pack_l1 int8 models. pre_tile=True keeps only the tile grid."""
    if pack not in (4, 8):
        raise ValueError(f"pack must be 4 or 8, got {pack}")
    device = resolve_device(device)
    h, w = int(image.shape[0]), int(image.shape[1])
    ty, tx, pad_y, pad_x = _grid(h, w, tile, halo)
    tp = (tile + 2 * halo) // pack  # packed tile extent incl. halo
    tc = tile // pack  # packed tile stride
    if isinstance(image, np.ndarray):
        packed_np = _host_pack_s2d(np.pad(image, (pad_y, pad_x, (0, 0)), mode="edge"), pack)
        if pre_tile:
            tiles_np = np.empty((ty * tx, tp, tp, packed_np.shape[-1]), np.uint8)
            for t in range(ty * tx):
                y0, x0 = (t // tx) * tc, (t % tx) * tc
                tiles_np[t] = packed_np[y0 : y0 + tp, x0 : x0 + tp]
            return FcnStagedSlide(None, h, w, tile, halo, pack,
                                  tiles=torch.from_numpy(tiles_np).to(device))
        return FcnStagedSlide(torch.from_numpy(packed_np).to(device), h, w, tile, halo, pack)
    packed = s2d_pack_image(edge_pad(image.to(device), pad_y, pad_x))
    if pack == 8:
        packed = _pack2_device(packed)
    if pre_tile:
        tiles = torch.stack([
            packed[(t // tx) * tc : (t // tx) * tc + tp, (t % tx) * tc : (t % tx) * tc + tp]
            for t in range(ty * tx)
        ])
        return FcnStagedSlide(None, h, w, tile, halo, pack, tiles=tiles)
    return FcnStagedSlide(packed, h, w, tile, halo, pack)


def _fc(model):
    """(kernel (in, out), bias) of the model's fc head, f32."""
    if getattr(model, "wants_uint8", False):
        return model.fc_kernel, model.fc_bias
    return model.fc.weight.detach().float().t(), model.fc.bias.detach().float()


def tile_logits(model, xin, hh: int, ft: int, fc_kernel, pre_packed=False):
    """The per-tile body (fcn.py:135): backbone features of a tile batch
    (``xin``: uint8 tiles, or the int8 ResNet's quantized ones), the halo
    cropped, cast to bf16, then projected by the f32 fc kernel."""
    f = model(model_input(model, xin), features=True, pre_packed=pre_packed)
    f = f[:, hh : hh + ft, hh : hh + ft].to(torch.bfloat16)
    return f.float() @ fc_kernel


def tile_steps(n_tiles: int, tile_batch: int) -> tuple[int, int]:
    """(tiles a step, steps) of a scan over ``n_tiles`` in steps of
    ``tile_batch``."""
    tb = max(1, min(tile_batch, n_tiles))
    return tb, -(-n_tiles // tb)


def fcn_logit_map(model, padded: torch.Tensor, pre_packed, ty: int, tx: int, tile: int,
                  halo: int, tile_batch: int, pre_tiled: bool = False) -> torch.Tensor:
    """The fc-projected stride-32 logit map (ty·ft, tx·ft, n_classes), ft =
    tile/32, of a slide on the (tile, halo) grid: ``padded`` the slide
    edge-padded by ``halo`` around ty × tx tiles (packed in ``pre_packed``'s
    units), or with ``pre_tiled`` its (ty·tx, T', T', C) tile stack. Steps of
    ``tile_batch`` tiles, the last one's excess lanes repeating the last
    tile (dropped here). The model is put in eval mode."""
    fs = FEATURE_STRIDE
    device = padded.device
    ft = tile // fs  # feature rows per tile
    hh = halo // fs
    n_tiles = ty * tx
    tb, n_steps = tile_steps(n_tiles, tile_batch)
    idx = np.minimum(np.arange(n_steps * tb), n_tiles - 1)
    pk = {False: 1, True: 4, "s2d8": 8}[pre_packed]
    tp, tc = (tile + 2 * halo) // pk, tile // pk

    lut = getattr(model, "input_lut", None)
    if lut is not None:
        # the int8 ResNet: K1's int8 mode gathers each step's tiles from the
        # tile stack (or the one padded slide), quantizes them and writes
        # them in the 4x4 form the s2d stem takes (or as they are for the
        # imagenet stem): the model quantizes and repacks nothing
        layout, model_packed = model.input_layout(pre_packed)
        bank = (padded if pre_tiled else padded[None]).contiguous()
        if pre_tiled:
            sidx, origin = idx, np.zeros((len(idx), 2), np.int64)
        else:
            sidx, origin = np.zeros_like(idx), np.stack([idx // tx, idx % tx], 1) * tc
        sidx = blocking_copy(torch.from_numpy(sidx.astype(np.int32)), device, "xfer.h2d")
        origin = blocking_copy(torch.from_numpy(origin.astype(np.int32)), device, "xfer.h2d")

        def gather_tiles(s):
            lanes = slice(s * tb, (s + 1) * tb)
            return gather_quantize_int8(bank, sidx[lanes], origin[lanes], tp, lut, layout)
    else:
        model_packed = pre_packed

        def gather_tiles(s):
            idxs = idx[s * tb : (s + 1) * tb]
            if pre_tiled:
                return padded[blocking_copy(torch.from_numpy(idxs), device, "xfer.h2d")]
            return torch.stack([
                padded[(t // tx) * tc : (t // tx) * tc + tp, (t % tx) * tc : (t % tx) * tc + tp]
                for t in idxs.tolist()
            ])

    model.eval()
    with torch.inference_mode():
        fc_kernel = _fc(model)[0]
        steps = [
            tile_logits(model, gather_tiles(s), hh, ft, fc_kernel, pre_packed=model_packed)
            for s in range(n_steps)
        ]
        tiles_l = torch.cat(steps)
        nc = tiles_l.shape[-1]
        return (
            tiles_l[:n_tiles].reshape(ty, tx, ft, ft, nc).permute(0, 2, 1, 3, 4)
            .reshape(ty * ft, tx * ft, nc)
        )


def predict_full_fcn(
    image,
    model,
    n_classes: int,
    patch_size: int = 224,
    downscale: int = 16,
    tile: int = 1024,
    halo: int = 64,
    tile_batch: int = 16,
    scan_unroll: int = 1,
    scan_prefetch: bool = False,
    device=None,
):
    """Overlap-free dense full-WSI prediction (module docstring); returns
    (argmax_map, score_map) as ``predict_full_fused`` does, the score map
    holding per-cell average window logits.

    image: (H, W, 3) uint8 (numpy or tensor) or an :class:`FcnStagedSlide`
    (s2d-stem models; pack=8 staging needs a pack_l1 int8 model). model: a
    ResNet-family backbone, float or int8, on ``device``. tile/halo:
    multiples of 32; ``tile_batch`` tiles run per step (the result does not
    depend on it). ``scan_unroll``/``scan_prefetch``: no-ops (module
    docstring). device: None runs on the current CUDA device and raises
    without one; ``"cpu"`` runs the plain versions of the kernels."""
    del scan_unroll, scan_prefetch
    check_uint8_classes(n_classes)
    if patch_size % FEATURE_STRIDE:
        raise ValueError(f"patch_size must be a multiple of {FEATURE_STRIDE}")
    if FEATURE_STRIDE % downscale:
        raise ValueError(f"downscale must divide {FEATURE_STRIDE}")
    if tile % FEATURE_STRIDE or halo % FEATURE_STRIDE:
        raise ValueError(f"tile and halo must be multiples of {FEATURE_STRIDE}")
    device = resolve_device(device)
    staged = isinstance(image, FcnStagedSlide)
    pre_packed = False
    if staged:
        if getattr(model, "stem", None) != "s2d":
            raise ValueError(
                "FcnStagedSlide is the s2d-packed representation; the model "
                f"has stem={getattr(model, 'stem', None)!r}"
            )
        if (image.tile, image.halo) != (tile, halo):
            raise ValueError(
                f"slide was staged for tile={image.tile}, halo={image.halo}; "
                f"this call asked for tile={tile}, halo={halo}"
            )
        pre_packed = True
        if image.pack == 8:
            if not getattr(model, "pack_l1", False):
                raise ValueError(
                    "pack=8 staging is the pre_packed='s2d8' representation "
                    "— it requires a pack_l1-quantized model (models/quantize.py)"
                )
            pre_packed = "s2d8"
        h, w = image.h, image.w
    else:
        image = upload_slide(image, device)
        h, w = int(image.shape[0]), int(image.shape[1])
    if h < patch_size or w < patch_size:
        raise ValueError(f"layer size {(h, w)} is smaller than patch_size {patch_size}")
    if model_device(model) != device:
        raise ValueError(
            f"model is on {model_device(model)}, the prediction on {device}; move it with "
            "model.to(device)"
        )

    fs = FEATURE_STRIDE
    wf = patch_size // fs  # feature cells per window axis (224/32 = 7)
    up = fs // downscale  # map cells per feature cell (32/16 = 2)
    ty, tx, pad_y, pad_x = _grid(h, w, tile, halo)
    ky = (h - patch_size) // fs + 1  # valid 32-aligned window corners per axis
    kx = (w - patch_size) // fs + 1
    mh, mw = h // downscale, w // downscale

    with span("predict.prepare", tiles=ty * tx):
        pre_tiled = False
        if staged:
            padded = image.tiles if image.tiles is not None else image.packed
            pre_tiled = image.tiles is not None
        else:
            # edge-replicated, not zero: the halo ring feeds real convolutions
            padded = edge_pad(image, pad_y, pad_x)
    with span("predict.enqueue", batches=tile_steps(ty * tx, tile_batch)[1]):
        logit_map = fcn_logit_map(model, padded.to(device), pre_packed, ty, tx, tile, halo,
                                  tile_batch, pre_tiled=pre_tiled)
        with torch.inference_mode():
            wlog = _avg_pool_f32(logit_map, wf)[:ky, :kx] + _fc(model)[1]
            argmax_map, score = _window_ensemble(wlog, wf, up, ky, kx, mh, mw)
    argmax_map = blocking_copy(argmax_map, "cpu", "predict.readback").numpy()
    return argmax_map, score


def fcn_equivalent_patches(h: int, w: int, patch_size: int = 224, stride: int = 112) -> int:
    """Number of exact-mode patches an fcn run replaces (for patches/s rows)."""
    return len(dense_coords(h, w, patch_size, stride))

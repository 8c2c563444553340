"""Row-banded full-WSI inference: the slide itself split over the ranks, a
port of ``deephisto_tpu/parallel/spatial.py``.

Each rank holds one band of the slide's rows and the halo a patch near the
band's edge reads, classifies the patches whose corner lies in its band,
and stitches them into a full-size map of its own; one all-reduce of the
map merges the bands. The JAX package runs the bands under ``shard_map``
over the ``data`` axis; here each rank runs its band, K1 gathering with
band-local corners and K2 stitching with the global ones
(:func:`predict_full_spatial`).

The fcn mode (:func:`predict_full_fcn_spatial`) bands on whole tile rows,
so each rank runs exactly the single predict's tiles of its rows; the one
coupling is the 7×7 window pool's ``wf - 1`` logit rows, which each rank
sends to the previous band (:func:`.._comm.halo_from_next`) before the pool,
and the window grid is gathered on every rank for the ensemble.

On a global mesh (:func:`.distributed.make_global_mesh`) the bands split
over host × data; on a (data, model) mesh over ``data``. Every rank of the
mesh calls with the same arguments and gets the same map.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.stitch import scatter_add_map_exact
from ..predict.fcn import (
    FEATURE_STRIDE,
    _avg_pool_f32,
    _fc,
    _host_pack_s2d,
    _window_ensemble,
    check_uint8_classes,
    fcn_logit_map,
)
from ..predict.pipeline import BatchPredictor, dense_coords, model_device
from ._comm import all_reduce_, gather_rows, halo_from_next
from .distributed import band_layout


def band_partition(h: int, n_bands: int, patch_size: int, halo: int = 0):
    """Row-band starts and size with a bottom halo of ``patch_size + halo``
    rows, so any patch whose corner lies in the band is readable locally.
    Bands are equal (h padded up); returns (starts, band_rows, padded_h)."""
    band = -(-h // n_bands)
    starts = np.arange(n_bands) * band
    band_rows = band + patch_size + halo
    padded_h = int(starts[-1] + band_rows)
    return starts.astype(np.int32), int(band_rows), padded_h


def _check_model(model, device) -> None:
    if model_device(model) != device:
        raise ValueError(
            f"model is on {model_device(model)}, the prediction on {device}; move it with "
            "model.to(device)"
        )


def _band(image, start: int, rows: int):
    """Rows [start, start + rows) of an (H, W, C) array or tensor, zero past
    its last row."""
    h = int(image.shape[0])
    part = image[start : min(start + rows, h)]
    if isinstance(image, torch.Tensor):
        out = image.new_zeros((rows, *image.shape[1:]))
    else:
        out = np.zeros((rows, *image.shape[1:]), dtype=image.dtype)
    out[: part.shape[0]] = part
    return out


def predict_full_spatial(
    image,
    model,
    n_classes: int,
    mesh,
    patch_size: int = 224,
    stride: int = 112,
    batch_size: int = 256,
    downscale: int = 16,
    device=None,
):
    """Dense full-WSI predict with the slide's rows banded over the mesh
    (module docstring). image: (H, W, 3) uint8, numpy or a tensor; each rank
    moves only its band and halo to ``device``. Returns the argmax class map
    (host numpy uint8), as the JAX function does.

    A rank's patches run in batches of ``batch_size``, the last padded by
    repeating its last corner and only its real lanes stitched. Each rank
    adds its patches into its own map in the single predict's order, so at
    one rank the map is the single predict's bit for bit; over more ranks
    a cell's sum is taken in another order."""
    check_uint8_classes(n_classes)
    device = resolve_device(device)
    _check_model(model, device)
    band_i, n_bands, group = band_layout(mesh)
    h, w = int(image.shape[0]), int(image.shape[1])
    ps, bs, d = patch_size, batch_size, downscale

    starts, band_rows, _ = band_partition(h, n_bands, ps)
    s0 = int(starts[band_i])
    band = torch.as_tensor(_band(image, s0, band_rows)).to(device)

    # the corners this band owns, in dense_coords' order
    coords = dense_coords(h, w, ps, stride)
    owner = np.minimum(coords[:, 0] // -(-h // n_bands), n_bands - 1)
    mine = coords[owner == band_i]
    n = len(mine)
    n_b = -(-n // bs)
    if n_b * bs > n:
        mine = np.concatenate([mine, np.repeat(mine[-1:], n_b * bs - n, axis=0)])
    mine = torch.from_numpy(mine)
    local = mine - torch.tensor([s0, 0], dtype=mine.dtype)

    step = BatchPredictor(band, False, model, ps, d, bs, device)
    score_map = torch.zeros((h // d, w // d, n_classes), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for b in range(n_b):
            real = min(bs, n - b * bs)
            logits = step.logits(local[b * bs : (b + 1) * bs].to(device))
            scatter_add_map_exact(score_map, mine[b * bs : b * bs + real].to(device),
                                  logits[:real], ps, d)
        # one all-reduce merges the band maps
        all_reduce_(score_map, group)
        return score_map.argmax(dim=-1).to(torch.uint8).cpu().numpy()


def predict_full_fcn_spatial(
    image,
    model,
    n_classes: int,
    mesh,
    patch_size: int = 224,
    downscale: int = 16,
    tile: int = 1024,
    halo: int = 64,
    tile_batch: int = 16,
    device=None,
):
    """Band-sharded overlap-free fcn predict (``predict/fcn.py``), the
    bands aligned to tile rows. Returns (argmax_map, score_map) as
    ``predict_full_fcn`` does, on every rank.

    image: (H, W, 3) uint8 (numpy, or a tensor read back to the host): each
    rank edge-pads its band (its tile rows and the halo ring), packs it on
    the host for an s2d-stem model (8×8 "s2d8" for a pack_l1 int8 model, as
    ``stage_for_fcn(pack=8)``, else 4×4) and moves it to ``device``. Each
    rank runs its band's tiles in steps of ``tile_batch``
    (``fcn_logit_map``), sends its first ``wf - 1`` logit rows to the
    previous band (the last band receives zeros: its tail windows lie past
    the slide), pools its windows and adds the fc bias; the window grid,
    gathered on every rank, goes through the single predict's ensemble.
    The tiles, the pool's windows and the ensemble are those of
    ``predict_full_fcn`` with the same tile, halo and tile_batch."""
    check_uint8_classes(n_classes)
    fs = FEATURE_STRIDE
    if patch_size % fs:
        raise ValueError(f"patch_size must be a multiple of {fs}")
    if fs % downscale:
        raise ValueError(f"downscale must divide {fs}")
    if tile % fs or halo % fs:
        raise ValueError(f"tile and halo must be multiples of {fs}")
    device = resolve_device(device)
    _check_model(model, device)
    band_i, n_dev, group = band_layout(mesh)
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    h, w = int(image.shape[0]), int(image.shape[1])
    if h < patch_size or w < patch_size:
        raise ValueError(f"layer size {(h, w)} is smaller than {patch_size}")

    wf = patch_size // fs
    up = fs // downscale
    ft = tile // fs
    ty = -(-h // tile)
    tx = -(-w // tile)
    ty_per = -(-ty // n_dev)  # tile rows a band (the last bands may be padding)
    wp = tx * tile
    ky = (h - patch_size) // fs + 1
    kx = (w - patch_size) // fs + 1
    mh, mw = h // downscale, w // downscale

    # this band of the edge-replicated slide (not zeros: black context is
    # out of distribution for a trained model), with the halo ring: padded
    # rows [start, start + band_rows) of the slide, rows clamped to it
    start = band_i * ty_per * tile - halo
    band_rows = ty_per * tile + 2 * halo
    lo = min(max(start, 0), h - 1)
    hi = max(min(start + band_rows, h), lo + 1)
    top = max(lo - start, 0)
    band = np.pad(np.asarray(image)[lo:hi],
                  ((top, band_rows - (hi - lo) - top), (halo, wp - w + halo), (0, 0)),
                  mode="edge")
    pre_packed = getattr(model, "stem", None) == "s2d"
    if pre_packed:
        pk = 8 if getattr(model, "pack_l1", False) else 4
        pre_packed = "s2d8" if pk == 8 else True
        band = _host_pack_s2d(band, pack=pk)
    band = torch.from_numpy(np.ascontiguousarray(band)).to(device)

    lmap = fcn_logit_map(model, band, pre_packed, ty_per, tx, tile, halo, tile_batch)
    with torch.inference_mode():
        # the halo exchange: the previous band's last windows pool over my
        # first wf - 1 logit rows (n_classes channels, not the features)
        recv = halo_from_next(lmap[: wf - 1], group)
        lmap_ext = torch.cat([lmap, recv], dim=0)
        wlog = _avg_pool_f32(lmap_ext, wf)[: ty_per * ft, :kx] + _fc(model)[1]
        wlog = gather_rows(wlog, group)[:ky]
        argmax_map, score = _window_ensemble(wlog, wf, up, ky, kx, mh, mw)
        return argmax_map.cpu().numpy(), score

"""Streamed full-WSI prediction for slides that fit the host but not the
card, a port of ``deephisto_tpu/predict/streaming.py``
(``predict_full_streamed``, ``predict_full_fcn_streamed``).

The slide is processed in horizontal stripes that own disjoint rows of
dense coordinates (or of fcn tiles), each staged on the card with the
overlap its patches (or its tiles' halo) need. While the card computes
stripe k, a host thread slices stripe k+1 (and packs it, for s2d-stem
models), copies it into pinned memory and queues its upload on a side CUDA
stream; the compute stream waits for that copy by event before it reads the
stripe, and the stripe's memory is marked as used by the compute stream
(``record_stream``). Only one stripe and the next are on the card at once.

Both are bit-identical to the resident predicts on the same model:

* dense: each stripe runs K1 on local coordinates and the forward in
  batches of its own coordinates, and keeps the scores; the scores are then
  stitched by K2 on global coordinates in the resident predict's order and
  batches (``predict_full_fused``), so every map cell sums the same values
  in the same order. The scores of the whole slide, (N, n_classes) f32,
  stay on the card (a 16384² slide: 21,025 patches, 0.4 MB).
* fcn: the tile grid is the resident one, cut at stripe seams; each stripe
  runs the resident's tile body (``fcn.tile_logits``) in tile batches of the
  resident's size, then the window pool on its logit rows with the previous
  stripe's last ``wf - 1`` logit rows carried across the seam, so each
  window sums the same rows; the window logits of all stripes then go
  through the resident's ensemble (``fcn._window_ensemble``).

``prestage_all`` uploads every stripe before the compute starts and reports
``staging_s`` and ``compute_s`` in ``timings``: a measurement aid that
separates the upload from the compute (every stripe is then on the card at
once).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._device import resolve_device
from ..ops.gather import gather_quantize_int8
from ..ops.stitch import scatter_add_map_exact
from .fcn import (
    FEATURE_STRIDE,
    _avg_pool_f32,
    _fc,
    _host_pack_s2d,
    _window_ensemble,
    check_uint8_classes,
    tile_logits,
)
from .pipeline import BatchPredictor, dense_coords, model_device


def _stripe_plan(h: int, patch_size: int, stride: int, target_rows: int):
    """Partition dense-coord rows into stripes (streaming.py:36): stripe k
    owns coords with y in [k·own, (k+1)·own) and needs rows [k·own, k·own +
    own + ps). Ownership covers y in [0, h-ps] inclusive, so when h-ps is an
    exact multiple of ``own`` the last dense row gets a stripe of its own."""
    own = max(stride, (target_rows // stride) * stride)
    n_stripes = -(-(max(h - patch_size, 0) + 1) // own)
    return own, n_stripes


class _StripeStager:
    """Stage stripes on ``device``: ``stage(k)`` gives stripe k's host array
    (uint8, (rows, W, C)); :meth:`upload` copies it through pinned memory on
    a side stream and returns the device tensor with the event of its copy;
    :meth:`take` makes the compute stream wait for that event. On the CPU
    the copy is the host array itself."""

    def __init__(self, stage, device: torch.device):
        self.stage, self.device = stage, device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def upload(self, k: int):
        host = torch.from_numpy(np.ascontiguousarray(self.stage(k)))
        if not self.cuda:
            return host, None
        torch.cuda.set_device(self.device)  # the prefetch thread's own device
        pinned = host.pin_memory()
        with torch.cuda.stream(self.stream):
            buf = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return buf, event

    def take(self, staged) -> torch.Tensor:
        buf, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            buf.record_stream(stream)
        return buf

    def run(self, n: int, compute, prestage_all: bool, timings: dict | None) -> None:
        """``compute(k, stripe)`` for k in 0..n-1 on the staged stripes: with
        the next upload prefetched by a host thread, or (``prestage_all``)
        after every upload, timing both into ``timings``."""
        if prestage_all:
            t0 = time.perf_counter()
            staged = [self.upload(k) for k in range(n)]
            if self.cuda:
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            for k in range(n):
                compute(k, self.take(staged[k]))
            if self.cuda:
                torch.cuda.synchronize(self.device)
            if timings is not None:
                timings["staging_s"] = t1 - t0
                timings["compute_s"] = time.perf_counter() - t1
            return
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="deephisto-stripe") as pool:
            nxt = pool.submit(self.upload, 0)
            for k in range(n):
                current = nxt.result()
                if k + 1 < n:
                    nxt = pool.submit(self.upload, k + 1)
                compute(k, self.take(current))


def predict_full_streamed(
    slide_layer,
    model,
    n_classes: int,
    patch_size: int = 224,
    stride: int = 112,
    batch_size: int = 256,
    downscale: int = 16,
    stripe_rows: int = 2048,
    softmax: bool = False,
    prestage_all: bool = False,
    timings: dict | None = None,
    device=None,
):
    """Dense full-WSI prediction with the slide streamed to the card in
    stripes of ``stripe_rows`` (rounded down to a multiple of ``stride``)
    owned coordinate rows. ``slide_layer``: an (H, W, 3) uint8 host array (a
    memory map is fine). Takes the models :func:`predict_full_fused` takes
    and returns what it returns, (argmax_map, score_map), bit for bit
    (module docstring). device: None runs on the current CUDA device and
    raises without one; ``"cpu"`` runs the plain versions of the kernels."""
    check_uint8_classes(n_classes)
    device = resolve_device(device)
    img = slide_layer
    h, w = int(img.shape[0]), int(img.shape[1])
    ps, bs, d = patch_size, batch_size, downscale
    if h < ps or w < ps:
        raise ValueError(f"layer {(h, w)} smaller than patch_size {ps}")
    if model_device(model) != device:
        raise ValueError(f"model is on {model_device(model)}, the prediction on {device}; "
                         "move it with model.to(device)")
    own, n_stripes = _stripe_plan(h, ps, stride, stripe_rows)
    stripe_h = own + ps  # rows staged per stripe: owned + one patch of overlap

    # the resident predict's coords, batches and padding (pipeline.py)
    coords = dense_coords(h, w, ps, stride)
    n = len(coords)
    n_b = -(-n // bs)
    coords = np.concatenate([coords, np.repeat(coords[-1:], n_b * bs - n, axis=0)])
    owner = np.minimum(coords[:n, 0] // own, n_stripes - 1)
    coords_dev = torch.from_numpy(coords).to(device)

    def stage(k):
        """Stripe k's rows [k·own, k·own + own + ps), zero rows below the
        slide."""
        rows = np.asarray(img[k * own : k * own + stripe_h])
        if rows.shape[0] < stripe_h:
            rows = np.pad(rows, ((0, stripe_h - rows.shape[0]), (0, 0), (0, 0)))
        return rows

    scores: list = [None]

    def compute(k, stripe):
        idx = np.flatnonzero(owner == k)
        if not len(idx):
            return
        n_own = len(idx)
        # whole batches, the last padded by repeating the stripe's last coord
        m = -(-n_own // bs) * bs
        idx = np.concatenate([idx, np.repeat(idx[-1:], m - n_own)])
        local = coords[idx] - np.array([k * own, 0], dtype=np.int32)
        local = torch.from_numpy(local).to(device)
        dest = torch.from_numpy(idx).to(device)
        step = BatchPredictor(stripe, False, model, ps, d, bs, device, softmax)
        for b in range(0, m, bs):
            lg = step.logits(local[b : b + bs])
            if scores[0] is None:
                scores[0] = torch.empty((n, lg.shape[-1]), dtype=lg.dtype, device=device)
            real = min(bs, n_own - b)
            scores[0][dest[b : b + real]] = lg[:real]

    score_map = torch.zeros((h // d, w // d, n_classes), dtype=torch.float32, device=device)
    with torch.inference_mode():
        _StripeStager(stage, device).run(n_stripes, compute, prestage_all, timings)
        for b in range(n_b):  # K2 as the resident predict calls it
            real = min(bs, n - b * bs)
            scatter_add_map_exact(score_map, coords_dev[b * bs : b * bs + real],
                                  scores[0][b * bs : b * bs + real], ps, d)
        argmax_map = score_map.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return argmax_map, score_map


def predict_full_fcn_streamed(
    slide_layer,
    model,
    n_classes: int,
    patch_size: int = 224,
    downscale: int = 16,
    stripe_rows: int = 2048,
    tile: int = 1024,
    halo: int = 64,
    tile_batch: int = 16,
    prestage_all: bool = False,
    timings: dict | None = None,
    device=None,
):
    """The fcn predict (``predict_full_fcn``) with the slide streamed to the
    card in stripes of ``stripe_rows`` pixel rows (rounded down to a
    multiple of ``tile``), each staged with ``halo`` rows of edge-replicated
    context on both sides and, for s2d-stem models, host-packed in the 4×4
    form (8×8 for a pack_l1 int8 model) by the prefetch thread. Returns
    (argmax_map, score_map), bit for bit those of ``predict_full_fcn`` on the
    same model (module docstring). ``slide_layer``: an (H, W, 3) uint8 host
    array. device: as :func:`predict_full_streamed`."""
    check_uint8_classes(n_classes)
    fs = FEATURE_STRIDE
    if patch_size % fs:
        raise ValueError(f"patch_size must be a multiple of {fs}")
    if fs % downscale:
        raise ValueError(f"downscale must divide {fs}")
    if tile % fs or halo % fs:
        raise ValueError(f"tile and halo must be multiples of {fs}")
    device = resolve_device(device)
    img = slide_layer
    h, w = int(img.shape[0]), int(img.shape[1])
    if h < patch_size or w < patch_size:
        raise ValueError(f"layer {(h, w)} smaller than patch_size {patch_size}")
    if model_device(model) != device:
        raise ValueError(f"model is on {model_device(model)}, the prediction on {device}; "
                         "move it with model.to(device)")
    wf = patch_size // fs
    up = fs // downscale
    own = max(tile, (stripe_rows // tile) * tile)
    if own // fs < wf - 1:
        raise ValueError("stripe_rows/tile too small for the window carry")
    n_stripes = -(-h // own)
    tx = -(-w // tile)
    wp = tx * tile
    ft, hh = tile // fs, halo // fs
    ky = (h - patch_size) // fs + 1
    kx = (w - patch_size) // fs + 1
    mh, mw = h // downscale, w // downscale
    ty_s = own // tile  # tile rows per stripe
    n_tiles = ty_s * tx
    # the resident program's tile batch (fcn.py), so every tile runs at the
    # batch size it runs at there
    tb = max(1, min(tile_batch, -(-h // tile) * tx))
    n_steps = -(-n_tiles // tb)
    idx = np.minimum(np.arange(n_steps * tb), n_tiles - 1)

    pre_packed = getattr(model, "stem", None) == "s2d"
    if pre_packed and getattr(model, "pack_l1", False):
        pre_packed = "s2d8"  # the pack_l1 int8 model takes the 8x8 form
    pk = {False: 1, True: 4, "s2d8": 8}[pre_packed]
    tp, tc = (tile + 2 * halo) // pk, tile // pk
    lut = getattr(model, "input_lut", None)
    if lut is not None:
        layout, model_packed = model.input_layout(pre_packed)
        sidx = torch.zeros((len(idx),), dtype=torch.int32, device=device)
        origin = torch.from_numpy(
            (np.stack([idx // tx, idx % tx], 1) * tc).astype(np.int32)).to(device)
    else:
        model_packed = pre_packed

    def stage(k):
        """Stripe k's rows [y0 - halo, y0 + own + halo), edge-replicated
        beyond the slide, the width padded to wp + 2·halo the same way (as
        the resident's ``mode='edge'`` padding), packed for s2d stems."""
        y0 = k * own
        ys = np.clip(np.arange(y0 - halo, y0 + own + halo), 0, h - 1)
        rows = np.asarray(img[ys[0] : ys[-1] + 1])
        top = halo - (y0 - int(ys[0]))
        bot = (own + 2 * halo) - rows.shape[0] - top
        rows = np.pad(rows, ((top, max(0, bot)), (halo, wp - w + halo), (0, 0)), mode="edge")
        if pre_packed:
            rows = _host_pack_s2d(rows, pack=8 if pre_packed == "s2d8" else 4)
        return rows

    def gather_tiles(stripe, s):
        if lut is not None:
            lanes = slice(s * tb, (s + 1) * tb)
            return gather_quantize_int8(stripe[None], sidx[lanes], origin[lanes], tp, lut, layout)
        return torch.stack([
            stripe[(t // tx) * tc : (t // tx) * tc + tp, (t % tx) * tc : (t % tx) * tc + tp]
            for t in idx[s * tb : (s + 1) * tb].tolist()
        ])

    model.eval()
    with torch.inference_mode():
        fc_kernel, fc_bias = _fc(model)
        pieces: list = []
        tail: list = [None]

        def compute(k, stripe):
            stripe = stripe.contiguous()
            steps = [tile_logits(model, gather_tiles(stripe, s), hh, ft, fc_kernel,
                                 pre_packed=model_packed) for s in range(n_steps)]
            tiles_l = torch.cat(steps)
            nc = tiles_l.shape[-1]
            logits = (tiles_l[:n_tiles].reshape(ty_s, tx, ft, ft, nc).permute(0, 2, 1, 3, 4)
                      .reshape(ty_s * ft, tx * ft, nc))
            if tail[0] is None:
                tail[0] = torch.zeros((wf - 1, tx * ft, nc), dtype=logits.dtype, device=device)
            cat = torch.cat([tail[0], logits])
            # the resident's window pool on this stripe's rows: window rows
            # r0-(wf-1) .. r0+fr-wf, each over the same logit rows
            pieces.append(_avg_pool_f32(cat, wf)[:, :kx])
            tail[0] = logits[-(wf - 1):] if wf > 1 else logits[:0]

        _StripeStager(stage, device).run(n_stripes, compute, prestage_all, timings)
        wlog = torch.cat(pieces)[wf - 1 : wf - 1 + ky] + fc_bias
        argmax_map, score = _window_ensemble(wlog, wf, up, ky, kx, mh, mw)
        argmax_map = argmax_map.cpu().numpy()
    return argmax_map, score

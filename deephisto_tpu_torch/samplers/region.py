"""Annotated-region patch samplers, a port of
``deephisto_tpu/samplers/region.py``: ``AnnoRegionRndSampler`` with its
region table and generator APIs, ``AnnoRegionDenseSampler`` and the test-set
extraction ``extract_and_save_subset``.

The region table's host construction (``_region_anchors``, ``_region_cells``,
``build_region_table``) is numpy, copied; the table then lives on the device.
The sampling step is a device program in torch, as in the JAX package:
class, image and region picks are Gumbel-max categoricals over padded log
weights, drawn from a ``torch.Generator`` on the device; each patch gets T
rejection trials (half uniform over the region's bbox, half inside proposal
cells that cover its valid corners) judged by exact polygon∩patch areas
(``geometry.device.clip_area_batch``), with a precomputed anchor as the
fallback when all T miss; patches come from the device bank through kernel
K1's multi-slide mode. torch's random streams are not JAX's, so the port is
held to the same distributions, not the same draws.

The JAX ``jax_generator`` is :meth:`AnnoRegionRndSampler.device_generator`
here (batches on the device); ``torch_generator`` and
``torch_iterable_dataset`` keep their names (CPU tensors). With a host-mode
bank the coordinates are still drawn on the device and the patches sliced on
the host, as in the JAX package. ``extract_and_save_subset`` writes the JAX
package's JPEG files through Pillow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..anno.parse import RegionAnnotation, parse_annotations
from ..geometry import clip_area_boxes, pad_polygons
from ..geometry.device import clip_area_batch
from ..ops.augment import preprocess_batch
from ..ops.gather import gather_multi_u8
from ..slide import Patch
from .bank import SlideBank
from .weights import calc_weights

DEFAULT_TRIALS = 32  # parallel rejection trials per patch
N_ANCHORS = 8
MAX_CELLS = 512  # proposal cells per region (mask-guided trials, thin regions)
MAX_CELL_EVALS = 16384  # cap on clip evaluations per region at table build
NEG_INF = -1e30  # log weight of an excluded entry (deephisto_tpu/ops/sampling.py)


@dataclass
class RegionTable:
    """All regions of a dataset as fixed-shape device tensors."""

    verts: torch.Tensor  # (R, MAX_V, 2) f32 layer-coord polygons (x, y)
    area: torch.Tensor  # (R,) f32
    class_idx: torch.Tensor  # (R,) i32
    image_idx: torch.Tensor  # (R,) i32
    sample_lo: torch.Tensor  # (R, 2) i32 — (y, x) inclusive lower trial bound
    sample_hi: torch.Tensor  # (R, 2) i32 — exclusive upper trial bound
    anchors: torch.Tensor  # (R, N_ANCHORS, 2) i32 — guaranteed-valid (y, x)
    n_anchors: torch.Tensor  # (R,) i32
    cells: torch.Tensor  # (R, MAX_CELLS, 2) i32 — proposal-cell lo corners (y, x)
    n_cells: torch.Tensor  # (R,) i32
    cell_step: torch.Tensor  # (R, 2) i32 — proposal-cell extent (dy, dx)
    feasible: np.ndarray  # (R,) bool (host)
    max_v: int


def _region_anchors(
    reg: RegionAnnotation, patch_size: int, region_intersection: float, k: int = N_ANCHORS
) -> np.ndarray:
    """Up to k dense-grid coords whose patch∩region area qualifies.

    These are the fixed-shape stand-in for the reference's unbounded retry
    loops: a patch whose T random trials all miss falls back to a random
    anchor, so every emitted patch is always valid.
    """
    x0, y0, x1, y1 = reg.bounds
    h, w = reg.layer_size
    ps = patch_size
    ylo, yhi = max(0, math.floor(y0)), min(math.ceil(y1) - ps, h - ps)
    xlo, xhi = max(0, math.floor(x0)), min(math.ceil(x1) - ps, w - ps)
    if yhi < ylo or xhi < xlo:
        # region smaller than a patch along an axis; single candidate row/col
        yhi, xhi = max(yhi, ylo), max(xhi, xlo)
    step_y = max(1, min(ps // 4, max(1, (yhi - ylo) // 32)))
    step_x = max(1, min(ps // 4, max(1, (xhi - xlo) // 32)))
    ys = np.arange(ylo, yhi + 1, step_y)
    xs = np.arange(xlo, xhi + 1, step_x)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    cand = np.stack([yy.ravel(), xx.ravel()], axis=1)
    boxes = np.stack(
        [cand[:, 1], cand[:, 0], cand[:, 1] + ps, cand[:, 0] + ps], axis=1
    ).astype(np.float64)
    areas = clip_area_boxes(reg.vertices_layer, boxes)
    ok = np.where(areas > ps * ps * region_intersection)[0]
    if len(ok) == 0:
        return np.zeros((0, 2), dtype=np.int32)
    pick = ok[np.linspace(0, len(ok) - 1, min(k, len(ok))).round().astype(int)]
    return cand[pick].astype(np.int32)


def _region_cells(
    reg: RegionAnnotation,
    patch_size: int,
    region_intersection: float,
    seed: int = 0,
    max_cells: int = MAX_CELLS,
    max_evals: int = MAX_CELL_EVALS,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Proposal cells: a conservative grid cover of the region's valid-corner
    set, for mask-guided rejection trials.

    The reference proposes patch corners uniformly in the region bbox and
    retries up to 500 times (region_samplers.py:120-142). For thin/serpentine
    regions the bbox acceptance rate can be ≪ 1/T, so uniform-bbox trials
    nearly always miss. These cells restrict proposals to grid cells that MAY
    contain a valid corner: a cell is kept when the exact clip area at its lo
    corner is within a Lipschitz slack (area moves at most ps·(dy+dx) when the
    corner moves by (dy, dx)) of the acceptance threshold, so the union of
    kept cells covers every valid corner. Proposals drawn uniformly from a
    kept cell + exact accept test ⇒ accepted corners are uniform over the
    valid set, exactly the reference's conditional distribution. Returns
    (cells (K, 2) int32 (y, x), (step_y, step_x)).
    """
    x0, y0, x1, y1 = reg.bounds
    h, w = reg.layer_size
    ps = patch_size
    ylo = int(np.clip(np.floor(y0), 0, max(0, h - ps)))
    xlo = int(np.clip(np.floor(x0), 0, max(0, w - ps)))
    yhi = int(np.clip(min(max(y0 + 1, y1 - ps), h - ps), ylo, h - ps))
    xhi = int(np.clip(min(max(x0 + 1, x1 - ps), w - ps), xlo, w - ps))
    side = int(np.sqrt(max_evals))
    cy = max(1, -(-(yhi - ylo + 1) // side))
    cx = max(1, -(-(xhi - xlo + 1) // side))
    ys = np.arange(ylo, yhi + 1, cy)
    xs = np.arange(xlo, xhi + 1, cx)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    cand = np.stack([yy.ravel(), xx.ravel()], axis=1)
    boxes = np.stack(
        [cand[:, 1], cand[:, 0], cand[:, 1] + ps, cand[:, 0] + ps], axis=1
    ).astype(np.float64)
    areas = clip_area_boxes(reg.vertices_layer, boxes)
    slack = ps * (cy + cx)
    keep = np.where(areas > ps * ps * region_intersection - slack)[0]
    if len(keep) == 0:
        return np.zeros((0, 2), dtype=np.int32), (cy, cx)
    if len(keep) > max_cells:
        rng = np.random.default_rng(seed + reg.region_idx)
        keep = rng.choice(keep, size=max_cells, replace=False)
    return cand[keep].astype(np.int32), (cy, cx)


def build_region_table(
    regions: dict[str, list[RegionAnnotation]],
    classes: list[str],
    patch_size: int,
    region_intersection: float,
    max_v: int | None = None,
    device=None,
) -> tuple[RegionTable, list[RegionAnnotation]]:
    """Flatten a parsed region dict into a RegionTable on ``device`` (+ the
    flat host list, index-aligned with the table rows)."""
    flat: list[RegionAnnotation] = []
    for cls in classes:
        flat.extend(regions.get(cls, []))
    if not flat:
        raise ValueError("no regions to sample from")

    if max_v is None:
        max_v = max(len(r.vertices_layer) for r in flat)
        max_v = max(8, -(-max_v // 8) * 8)

    ps = patch_size
    R = len(flat)
    verts = pad_polygons([r.vertices_layer for r in flat], max_v)
    area = np.array([r.area for r in flat], dtype=np.float32)
    class_idx = np.array([classes.index(r.class_) for r in flat], dtype=np.int32)
    image_idx = np.array([r.image_idx for r in flat], dtype=np.int32)

    lo = np.zeros((R, 2), dtype=np.int32)
    hi = np.zeros((R, 2), dtype=np.int32)
    anchors = np.zeros((R, N_ANCHORS, 2), dtype=np.int32)
    n_anchors = np.zeros((R,), dtype=np.int32)
    cells = np.zeros((R, MAX_CELLS, 2), dtype=np.int32)
    n_cells = np.zeros((R,), dtype=np.int32)
    cell_step = np.ones((R, 2), dtype=np.int32)
    feasible = np.zeros((R,), dtype=bool)

    for i, r in enumerate(flat):
        x0, y0, x1, y1 = r.bounds
        h, w = r.layer_size
        # trial bounds mirror reference region_samplers.py:123-124, additionally
        # clamped so patches stay inside the layer (the reference could sample
        # up to w/h and rely on the codec; we keep gathers in-bounds)
        ylo = int(np.clip(np.floor(y0), 0, max(0, h - ps)))
        xlo = int(np.clip(np.floor(x0), 0, max(0, w - ps)))
        yhi = int(np.clip(min(max(y0 + 1, y1 - ps), h - ps), ylo, h - ps)) + 1
        xhi = int(np.clip(min(max(x0 + 1, x1 - ps), w - ps), xlo, w - ps)) + 1
        lo[i] = (ylo, xlo)
        hi[i] = (yhi, xhi)
        if r.area >= ps * ps * region_intersection:
            a = _region_anchors(r, ps, region_intersection)
            n_anchors[i] = len(a)
            anchors[i, : len(a)] = a
            feasible[i] = len(a) > 0
            if feasible[i]:
                c, (cy, cx) = _region_cells(r, ps, region_intersection)
                n_cells[i] = len(c)
                cells[i, : len(c)] = c
                cell_step[i] = (cy, cx)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))

    table = RegionTable(
        verts=dev(verts),
        area=dev(area),
        class_idx=dev(class_idx),
        image_idx=dev(image_idx),
        sample_lo=dev(lo),
        sample_hi=dev(hi),
        anchors=dev(anchors),
        n_anchors=dev(np.maximum(n_anchors, 1)),
        cells=dev(cells),
        n_cells=dev(np.maximum(n_cells, 1)),
        cell_step=dev(cell_step),
        feasible=feasible,
        max_v=max_v,
    )
    return table, flat


# ---------------------------------------------------------------------------
# Random region sampler
# ---------------------------------------------------------------------------


def _categorical(gen: torch.Generator, logits: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Gumbel-max draw(s) over the last axis of ``logits``: one per leading
    row, or ``n`` of a 1-D ``logits``."""
    shape = logits.shape if n is None else (n,) + tuple(logits.shape)
    u = torch.rand(shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


class AnnoRegionRndSampler:
    """Class-balanced weighted random patch sampler over annotated regions.

    Per batch, as the JAX sampler (reference region_samplers.py:525-591):
    G = ceil(batch/k) weighted region draws, k patches per region
    (``patches_from_one_region``), optional ``one_image_for_batch`` pinning,
    uniform class choice, per-class weighted region choice with
    ``region_area_influence`` area blending. ``device``: where the region
    table, the bank and the draws live (the current CUDA device by default,
    ``"cpu"`` for the plain versions); ``seed`` seeds :meth:`sample_batch`'s
    generator there.
    """

    def __init__(
        self,
        img_anno_paths: list[tuple[Path, Path]],
        layer: int,
        patch_size: int,
        region_intersection: float = 0.75,
        patches_from_one_region: int = 4,
        region_area_influence: float = 0.5,
        classes: list[str] | None = None,
        one_image_for_batch: bool = False,
        seed: int = 0,
        n_trials: int = DEFAULT_TRIALS,
        slide_bank: SlideBank | None = None,
        verbose: bool = True,
        device=None,
    ):
        self.img_anno_paths = img_anno_paths
        self.layer = layer
        self.patch_size = patch_size
        self.region_intersection = region_intersection
        self.patches_from_one_region = patches_from_one_region
        self.region_area_influence = region_area_influence
        self.one_image_for_batch = one_image_for_batch
        self.n_trials = n_trials
        self.device = resolve_device(device) if slide_bank is None else slide_bank.device
        self._gen = torch.Generator(self.device).manual_seed(seed)

        self.regions, self.regions_per_image = parse_annotations(
            img_anno_paths, layer=layer, classes=classes, verbose=verbose
        )
        self.classes = sorted(self.regions.keys())
        if verbose:
            self._print_anno_stats(self.regions)

        (
            self._reg_w_all,
            self._reg_w_per_img,
            self._img_w,
            self._img_w_all,
        ) = calc_weights(
            self.regions,
            self.regions_per_image,
            self.classes,
            region_area_influence,
        )

        self.table, self._flat_regions = build_region_table(
            self.regions, self.classes, patch_size, region_intersection, device=self.device
        )
        self._build_weight_matrices()

        self.bank = slide_bank or SlideBank(
            [p for p, _ in img_anno_paths], layer=layer, device=self.device
        )
        self._hw = torch.from_numpy(self.bank.layer_hw_arr).to(self.device)

    # -- construction helpers ------------------------------------------------

    def _print_anno_stats(self, regions):
        areas_per_cls = {
            cls: sum(r.area for r in regs) for cls, regs in regions.items()
        }
        total = sum(areas_per_cls.values())
        print("Total area per class:")
        for cls, a in areas_per_cls.items():
            print(f"\t{cls}: {round(a / 1e9, 2)} Gpx ({round(a / total * 100, 2)}%)")
        print(f"Approximate number of patches in dataset: {len(self)}")

    def _build_weight_matrices(self):
        """Pad the per-class / per-image weight dicts into dense matrices over
        the global region axis, zeroing infeasible regions (numpy, as the
        JAX sampler builds them), then stage them on the device."""
        C = len(self.classes)
        R = len(self._flat_regions)
        n_img = len(self.img_anno_paths)
        feas = self.table.feasible

        w_cls_region = np.zeros((C, R), dtype=np.float32)
        w_img_cls_region = np.zeros((n_img, C, R), dtype=np.float32)

        # map each flat row back to its position within its class / image lists
        pos_in_class: dict[str, int] = {c: 0 for c in self.classes}
        pos_in_img: dict[tuple[int, str], int] = {}
        for r_idx, reg in enumerate(self._flat_regions):
            c = self.classes.index(reg.class_)
            j = pos_in_class[reg.class_]
            pos_in_class[reg.class_] = j + 1
            if feas[r_idx]:
                w_cls_region[c, r_idx] = self._reg_w_all[reg.class_][j]
            key = (reg.image_idx, reg.class_)
            jj = pos_in_img.get(key, 0)
            pos_in_img[key] = jj + 1
            if feas[r_idx]:
                w_img_cls_region[reg.image_idx, c, r_idx] = self._reg_w_per_img[
                    reg.image_idx
                ][reg.class_][jj]

        def _lognorm(w, axis):
            s = w.sum(axis=axis, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.where(w > 0, np.log(np.maximum(w / np.maximum(s, 1e-38), 1e-38)), NEG_INF)
            return out.astype(np.float32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

        self._logw_cls_region = dev(_lognorm(w_cls_region, 1))
        self._logw_img_cls_region = dev(_lognorm(w_img_cls_region, 2))
        self._cls_available = dev(np.where(w_cls_region.sum(1) > 0, 0.0, NEG_INF))
        self._img_cls_available = dev(np.where(w_img_cls_region.sum(2) > 0, 0.0, NEG_INF))
        # images with zero feasible regions must never be drawn in
        # one_image_for_batch mode (their class categorical would be
        # degenerate) — mask them out of the image weights
        img_feasible = w_img_cls_region.sum(axis=(1, 2)) > 0
        self._logw_img_all = dev(
            np.where(img_feasible, np.log(np.maximum(self._img_w_all, 1e-38)), NEG_INF)
        )

    # -- the device sampling step --------------------------------------------

    def _check_forced_cls(self, forced_cls: int | None):
        """Forcing a class with zero feasible regions would degenerate the
        region categorical (all -inf logits -> arbitrary region of any class,
        i.e. silently mislabeled patches). Fail loudly instead."""
        if forced_cls is None:
            return
        feas = self.table.feasible & (
            self.table.class_idx.cpu().numpy() == forced_cls
        )
        if not feas.any():
            raise ValueError(
                f"class {forced_cls} ({self.classes[forced_cls]}) has no "
                f"feasible regions for patch_size={self.patch_size} at "
                f"intersection {self.region_intersection}"
            )

    def _draw(self, gen: torch.Generator, n: int, forced_cls: int | None) -> dict:
        """One batch's random draws from ``gen``, in a fixed order: the image
        (``one_image_for_batch``), G classes, G regions, then the trials'
        uniforms, the proposal cells and the anchor picks."""
        k = self.patches_from_one_region
        G = -(-n // k)
        T = self.n_trials
        T1 = max(1, T // 2)
        T2 = T - T1
        dev = self.device
        if self.one_image_for_batch:
            img_logits = self._logw_img_all
            if forced_cls is not None:
                # the pinned image must hold a feasible region of the forced
                # class, or the region categorical would be degenerate
                img_logits = img_logits + self._img_cls_available[:, forced_cls]
            img = _categorical(gen, img_logits)
            cls_logits = self._img_cls_available[img]  # (C,)
            logw_region = self._logw_img_cls_region[img]  # (C, R)
        else:
            cls_logits = self._cls_available
            logw_region = self._logw_cls_region
        if forced_cls is None:
            cls = _categorical(gen, cls_logits, G)
        else:
            cls = torch.full((G,), forced_cls, dtype=torch.int64, device=dev)
        return {
            "cls": cls,
            "region": _categorical(gen, logw_region[cls]),  # (G,)
            "u": torch.rand((G, k, T1, 2), generator=gen, device=dev),
            "ci": torch.randint(0, 1_000_000, (G, k, T2), generator=gen, device=dev),
            "cj": torch.rand((G, k, T2, 2), generator=gen, device=dev),
            "a_idx": torch.randint(0, 1_000_000, (G, k), generator=gen, device=dev),
        }

    def _resolve(self, d: dict):
        """Coordinates from the draws of any number of batches concatenated
        along G: the rejection trials, their exact clip areas, the first
        accepted trial of each patch or its anchor. Returns (labels (G·k,),
        coords (G·k, 2), img_idx (G·k,)), int32."""
        t = self.table
        ps, ri = self.patch_size, self.region_intersection
        region, u, ci, cj = d["region"], d["u"], d["ci"], d["cj"]
        G, k = u.shape[0], u.shape[1]
        T = u.shape[2] + ci.shape[2]

        # rejection trials, (G, k, T) candidate corners: the first T1 uniform
        # over the region bbox (the reference's proposal distribution), the
        # rest uniform inside proposal cells that cover the valid-corner set;
        # both are uniform where they can accept
        lo, hi = t.sample_lo[region], t.sample_hi[region]  # (G, 2)
        rlo, rhi = lo.float(), hi.float()
        yx = torch.floor(rlo[:, None, None, :] + u * (rhi - rlo)[:, None, None, :]).int()
        if ci.shape[2] > 0:
            ci = ci % t.n_cells[region][:, None, None]
            cell_lo = torch.gather(
                t.cells[region][:, None].expand(G, k, -1, 2), 2,
                ci[..., None].expand(-1, -1, -1, 2).long(),
            )  # (G, k, T2, 2)
            step = t.cell_step[region][:, None, None, :]
            yx_cell = cell_lo + torch.floor(cj * step).int()
            yx_cell = torch.minimum(
                torch.maximum(yx_cell, lo[:, None, None, :]), hi[:, None, None, :] - 1
            )
            yx = torch.cat([yx, yx_cell], dim=2)

        yf, xf = yx[..., 0].float(), yx[..., 1].float()
        boxes = torch.stack([xf, yf, xf + ps, yf + ps], dim=-1)  # (G, k, T, 4)
        trial_verts = t.verts[region][:, None, None].expand(G, k, T, t.max_v, 2)
        areas = clip_area_batch(trial_verts.reshape(G * k * T, t.max_v, 2),
                                boxes.reshape(G * k * T, 4))
        accept = (areas > ps * ps * ri).reshape(G, k, T)

        first = torch.argmax(accept.to(torch.uint8), dim=-1)  # (G, k) first accepted
        got = accept.any(dim=-1)
        take = torch.gather(yx, 2, first[:, :, None, None].expand(G, k, 1, 2))[:, :, 0]

        # anchor fallback for all-miss patches
        a_idx = d["a_idx"] % t.n_anchors[region][:, None]
        anchor = torch.gather(t.anchors[region], 1, a_idx[..., None].expand(G, k, 2).long())
        coords = torch.where(got[..., None], take, anchor)  # (G, k, 2)

        labels = d["cls"][:, None].expand(G, k).reshape(-1).int()
        img_idx = t.image_idx[region][:, None].expand(G, k).reshape(-1)
        return labels, coords.reshape(-1, 2).int(), img_idx.int()

    def sample_coords(self, gens: list[torch.Generator], n: int, forced_cls: int | None = None):
        """The coordinates of ``len(gens)`` batches of ``n``, batch i drawn
        from ``gens[i]``: (labels (S, n), coords (S, n, 2), img_idx (S, n)).
        The draws of each batch depend on its generator alone, and the
        geometry of all of them runs as one batch, so batch i equals what
        ``make_sample_fn(n, gather=False)(gens[i])`` gives."""
        self._check_forced_cls(forced_cls)
        draws = [self._draw(g, n, forced_cls) for g in gens]
        labels, coords, img_idx = self._resolve(
            {key: torch.cat([d[key] for d in draws]) for key in draws[0]}
        )
        s = len(gens)
        rows = labels.shape[0] // s
        return (labels.reshape(s, rows)[:, :n], coords.reshape(s, rows, 2)[:, :n],
                img_idx.reshape(s, rows)[:, :n])

    def make_sample_fn(
        self,
        n: int,
        forced_cls: int | None = None,
        gather: bool = True,
        context: int = 0,
    ):
        """A function ``gen -> (patches_u8, labels, coords, img_idx)`` of one
        batch of ``n`` drawn from the device generator ``gen``; with
        ``gather=False`` it yields ``(labels, coords, img_idx)`` only.

        ``context > 0``: the label still comes from the ``patch_size`` patch
        at the sampled coords, but the gathered pixels are the
        ``patch_size + 2*context`` window around it, clamped per image to the
        true layer bounds (see the JAX sampler's docstring)."""
        self._check_forced_cls(forced_cls)
        if gather and not self.bank.on_device:
            raise ValueError(
                "make_sample_fn(gather=True) requires a device-resident SlideBank; "
                "this bank is on the host. Use gather=False and gather on the "
                "host, or sample_batch and the generator APIs, which handle host mode."
            )
        if context and not gather:
            raise ValueError("context requires gather=True")
        if context < 0:
            raise ValueError("context must be non-negative")
        gather_fn = self.make_gather_fn(context) if gather else None

        def fn(gen):
            labels, coords, img_idx = (x[0] for x in self.sample_coords([gen], n, forced_cls))
            if gather_fn is None:
                return labels, coords, img_idx
            return gather_fn(img_idx, coords), labels, coords, img_idx

        return fn

    def make_gather_fn(self, context: int = 0):
        """The gather half of ``make_sample_fn``: ``(img_idx, coords) ->
        windows_u8`` over the device bank (kernel K1's multi-slide mode), for
        callers that sample coordinates separately (the fused epoch's
        presampling). ``context`` as in ``make_sample_fn``."""
        if not self.bank.on_device:
            raise ValueError("make_gather_fn requires a device-resident bank")
        ps = self.patch_size
        images = self.bank.images
        if context == 0:
            return lambda img_idx, coords: gather_multi_u8(images, img_idx, coords, ps)
        win = ps + 2 * context
        hw = self.bank.layer_hw_arr
        if (hw < win).any():
            raise ValueError(
                f"context window {win} exceeds a slide layer: {hw.min(0)}"
            )

        def g(img_idx, coords):
            start = torch.minimum((coords - context).clamp_min(0), self._hw[img_idx.long()] - win)
            return gather_multi_u8(images, img_idx, start.int(), win)

        return g

    def sample_batch(self, n: int, forced_cls: int | None = None):
        """One batch (patches_u8, labels, coords, img_idx) from the sampler's
        own generator (seeded by ``seed``). With a host-mode bank the
        coordinates come from the device step and the patches from the
        host."""
        if self.bank.on_device:
            return self.make_sample_fn(n, forced_cls)(self._gen)
        labels, coords, img_idx = self.make_sample_fn(n, forced_cls, gather=False)(self._gen)
        return self.bank.gather(img_idx, coords, self.patch_size), labels, coords, img_idx

    # -- public generator API (reference parity) -----------------------------

    def structs_generator(
        self,
        batch_size: int,
        n_batches: int,
        batches_per_worker: int = 2,
        max_workers: int | None = None,
        cls_idx: int | None = None,
    ) -> Iterator[list[tuple[Patch, int]]]:
        """Yield ``n_batches`` lists of (Patch, class_idx).

        ``batches_per_worker`` / ``max_workers`` are accepted for API parity
        with the process-pool reference (region_samplers.py:641-683) but are
        no-ops: batches come from the device pipeline."""
        for _ in range(n_batches):
            patches, labels, coords, _ = self.sample_batch(batch_size, cls_idx)
            data, lab, crd = patches.cpu().numpy(), labels.cpu().numpy(), coords.cpu().numpy()
            yield [
                (Patch(layer=self.layer, pos_x=int(crd[i, 1]), pos_y=int(crd[i, 0]),
                       patch_size=self.patch_size, data=data[i]), int(lab[i]))
                for i in range(batch_size)
            ]

    def device_generator(
        self,
        batch_size: int,
        n_batches: int,
        cls_idx: int | None = None,
        augment: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        """Device-resident fast path (the JAX ``jax_generator``): yields
        (features, labels, coords) on the device, features normalized (and
        with ``augment`` flip-augmented from the sampler's generator)."""
        for _ in range(n_batches):
            patches, labels, coords, _ = self.sample_batch(batch_size, cls_idx)
            feats = preprocess_batch(patches, self._gen if augment else None, augment, dtype)
            yield feats, labels, coords.float()

    def torch_generator(
        self,
        batch_size: int,
        n_batches: int,
        batches_per_worker: int = 2,
        transforms=None,
        max_workers: int | None = None,
        cls_idx: int | None = None,
    ):
        """Reference-parity torch output on the CPU: (features f32 NHWC /255,
        labels int64, coords f32) per batch (region_samplers.py:685-738)."""
        for feats, labels, coords in self.device_generator(batch_size, n_batches, cls_idx=cls_idx):
            f = feats.cpu()
            if transforms is not None:
                f = transforms(f)
            yield f, labels.cpu().long(), coords.cpu()

    def torch_iterable_dataset(self):
        """Infinite torch IterableDataset over single patches
        (region_samplers.py:740-786; coords fixed to (y, x))."""
        from torch.utils.data import IterableDataset

        sampler = self

        class _DS(IterableDataset):
            def __iter__(self):
                while True:
                    for f, lab, c in sampler.torch_generator(sampler.patches_from_one_region, 1):
                        for i in range(f.shape[0]):
                            yield f[i], lab[i], c[i]

        return _DS()

    def __len__(self):
        """Approximate dataset size (reference region_samplers.py:788-796)."""
        ps = self.patch_size * self.layer
        return int(
            sum(sum(r.area for r in lst) for lst in self.regions.values())
            / (ps * ps)
        )


# ---------------------------------------------------------------------------
# Dense region sampler
# ---------------------------------------------------------------------------


class AnnoRegionDenseSampler:
    """Deterministic dense-grid patch extraction over annotated regions
    (reference region_samplers.py:799-871): for each class, each region, every
    stride-grid patch whose exact intersection area qualifies, in order.
    ``device`` as for :class:`AnnoRegionRndSampler`."""

    def __init__(
        self,
        img_anno_paths: list[tuple[Path, Path]],
        layer: int,
        patch_size: int,
        stride: int,
        region_intersection: float = 0.75,
        classes: list[str] | None = None,
        slide_bank: SlideBank | None = None,
        verbose: bool = True,
        device=None,
    ):
        self.img_anno_paths = img_anno_paths
        self.layer = layer
        self.patch_size = patch_size
        self.stride = stride
        self.region_intersection = region_intersection
        self.regions, _ = parse_annotations(
            img_anno_paths, layer=layer, classes=classes, verbose=verbose
        )
        self.classes = sorted(self.regions.keys())
        self.bank = slide_bank or SlideBank(
            [p for p, _ in img_anno_paths], layer=layer, device=device
        )
        self.device = self.bank.device

    def _region_coords(self, reg: RegionAnnotation) -> np.ndarray:
        """Qualifying dense-grid (y, x) coords for one region — the vectorized
        equivalent of reference region_samplers.py:145-191."""
        ps = self.patch_size
        h, w = reg.layer_size
        x0, y0, x1, y1 = (round(v) for v in reg.bounds)
        x1 = min(x1, w - ps)
        y1 = min(y1, h - ps)
        ys = np.arange(y0, y1, self.stride)
        xs = np.arange(x0, x1, self.stride)
        if len(ys) == 0 or len(xs) == 0:
            return np.zeros((0, 2), dtype=np.int32)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        cand = np.stack([yy.ravel(), xx.ravel()], axis=1)
        boxes = np.stack(
            [cand[:, 1], cand[:, 0], cand[:, 1] + ps, cand[:, 0] + ps], axis=1
        ).astype(np.float64)
        areas = clip_area_boxes(reg.vertices_layer, boxes)
        ok = areas > ps * ps * self.region_intersection
        return cand[ok].astype(np.int32)

    def all_coords(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every qualifying patch of the dense pass, precomputed:
        (coords (N, 2), labels (N,), image_idx (N,)) in the reference's
        class-by-class, region-by-region order."""
        coords_l, labels_l, imgs_l = [], [], []
        for cls_idx, cls in enumerate(self.classes):
            for reg in self.regions[cls]:
                c = self._region_coords(reg)
                if len(c):
                    coords_l.append(c)
                    labels_l.append(np.full((len(c),), cls_idx, dtype=np.int32))
                    imgs_l.append(np.full((len(c),), reg.image_idx, dtype=np.int32))
        if not coords_l:
            z = np.zeros((0,), np.int32)
            return np.zeros((0, 2), np.int32), z, z
        return (
            np.concatenate(coords_l),
            np.concatenate(labels_l),
            np.concatenate(imgs_l),
        )

    def structs_generator(self) -> Iterator[tuple[Patch, int]]:
        """Yield every qualifying (Patch, class_idx), class by class, region by
        region (reference region_samplers.py:866-871), gathering from the
        bank in chunks."""
        chunk = 256
        for cls_idx, cls in enumerate(self.classes):
            for reg in self.regions[cls]:
                coords = self._region_coords(reg)
                for s in range(0, len(coords), chunk):
                    c = coords[s : s + chunk]
                    sidx = np.full((len(c),), reg.image_idx, dtype=np.int32)
                    data = self.bank.gather(sidx, c, self.patch_size).cpu().numpy()
                    for i in range(len(c)):
                        yield (
                            Patch(layer=self.layer, pos_x=int(c[i, 1]), pos_y=int(c[i, 0]),
                                  patch_size=self.patch_size, data=data[i]),
                            cls_idx,
                        )

    def device_generator(self, batch_size: int, dtype: torch.dtype = torch.float32):
        """Batched pass over every qualifying patch on the device (the JAX
        ``jax_generator``): yields (features, labels, coords) with the last
        batch padded by repeating the final patch (same rule as the full dense
        sampler, reference full_samplers.py:400-402)."""
        coords, labels, img_idx = self.all_coords()
        n = len(coords)
        if n == 0:
            return
        pad = (-n) % batch_size
        if pad:
            coords = np.concatenate([coords, np.repeat(coords[-1:], pad, 0)])
            labels = np.concatenate([labels, np.repeat(labels[-1:], pad)])
            img_idx = np.concatenate([img_idx, np.repeat(img_idx[-1:], pad)])
        for s in range(0, len(coords), batch_size):
            c = coords[s : s + batch_size]
            patches = self.bank.gather(img_idx[s : s + batch_size], c, self.patch_size)
            yield (
                preprocess_batch(patches, dtype=dtype),
                torch.from_numpy(labels[s : s + batch_size]).to(self.device),
                torch.from_numpy(c.astype(np.float32)).to(self.device),
            )


# ---------------------------------------------------------------------------
# Test-set extraction
# ---------------------------------------------------------------------------


def extract_and_save_subset(
    img_anno_paths: list[tuple[Path, Path]],
    out_folder: Path,
    patch_size: int,
    layer: int,
    patches_per_class: int,
    intersection: float = 0.95,
    seed: int = 0,
    device=None,
):
    """Build an ImageFolder-layout patch dataset on disk,
    ``out_folder/<class_idx>/<count>.jpg``, written by Pillow as the JAX
    package writes it (reference region_samplers.py:874-909) — with the
    class-forcing bug fixed, so class-k folders really contain class-k
    patches. A class whose regions cannot host a patch at ``intersection``
    leaves an empty folder."""
    from PIL import Image

    sampler = AnnoRegionRndSampler(
        img_anno_paths=img_anno_paths,
        layer=layer,
        patch_size=patch_size,
        region_intersection=intersection,
        region_area_influence=0,  # equal weights for all regions
        patches_from_one_region=1,  # only one patch per region
        seed=seed,
        device=device,
    )

    batch_size = 4
    out_folder = Path(out_folder)
    for cls_idx, cls in enumerate(sampler.classes):
        (out_folder / str(cls_idx)).mkdir(parents=True, exist_ok=True)
        try:
            sampler._check_forced_cls(cls_idx)
        except ValueError as e:
            # skip-and-report tolerance (the reference's failure semantics):
            # a class whose regions can't host a patch at this intersection
            # yields an empty folder instead of aborting the run
            print(f"skipping class {cls}: {e}")
            continue
        # ceil + cap: floor division would save 0 patches for
        # patches_per_class < batch_size and silently drop the remainder
        n = -(-patches_per_class // batch_size)
        count = 0
        for batch in sampler.structs_generator(batch_size=batch_size, n_batches=n, cls_idx=cls_idx):
            for patch, _ in batch:
                if count >= patches_per_class:
                    break
                Image.fromarray(patch.data).save(out_folder / str(cls_idx) / f"{count}.jpg")
                count += 1
    return out_folder

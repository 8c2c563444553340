"""Whole-slide patch samplers: coverage-guided random and dense tiling, a
port of ``deephisto_tpu/samplers/full.py``.

Each random step runs on the device, in torch: a Gumbel-top-k draw of
coverage cells without replacement (``ops.sampling.coverage_cell_topk``),
a jitter, a clamp, the patch gather (kernel K1) and the coverage update
(``ops.stitch.accumulate_coverage``, kernel K2). Saturated cells are drawn
only when fewer than batch_size unsaturated ones remain (the reference's
add-random-empty-cells rule, full_samplers.py:105-114).

K1 gathers in its uint8 mode where the consumer wants bytes
(:meth:`device_generator`, :meth:`generator`) and in its float32 mode,
``u8 · f32(1/255)``, for :meth:`generator_torch` (which normalizes /255 in
both samplers, as the JAX package does; the reference's random sampler
forgot it, SURVEY.md §2b.8). A layer over ``DEVICE_SLIDE_BUDGET`` bytes,
or memory-mapped in ONDISK mode, stays on the host: its patches are sliced
there and uploaded from pinned memory, the coordinates, coverage and
everything after the gather staying on the device, as in the JAX package.

torch's random streams are not JAX's: the samplers are held to the same
distributions, and to the same cells on the same injected noise
(:func:`_rnd_draws` is the one place a step draws).
"""

from __future__ import annotations

import contextlib
import os
from enum import Enum
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import native
from .._device import resolve_device
from ..ops.gather import gather_multi_u8, gather_normalize
from ..ops.sampling import coverage_cell_topk, gumbel
from ..ops.stitch import accumulate_coverage, coverage_footprint
from ..slide import Patch, Slide, open_slide


class SamplerExecutionMode(Enum):
    """API parity with reference full_samplers.py:16-18: INMEMORY_SINGLEPROC
    materializes the layer (on the device when it fits the budget);
    ONDISK_MULTIPROC keeps a DHS layer memory-mapped on the host, patches
    sliced from it touching only the pages they need."""

    INMEMORY_SINGLEPROC = 1
    ONDISK_MULTIPROC = 2


# the JAX package's knob and environment variable, with its default
DEVICE_SLIDE_BUDGET = int(
    float(os.environ.get("DEEPHISTO_DEVICE_SLIDE_BUDGET", 12 << 30))
)


def _stage(data: np.ndarray, device: torch.device, ondisk: bool = False):
    """Stage a slide layer for gathering → (image, on_device): a uint8
    tensor on ``device`` when it fits the budget (and is not an ONDISK
    mmap), else the host array."""
    if ondisk and isinstance(data, np.memmap):
        return data, False
    data = np.ascontiguousarray(data)
    if data.nbytes <= DEVICE_SLIDE_BUDGET:
        return torch.from_numpy(data).to(device), True
    return data, False


def _host_gather(data: np.ndarray, coords, ps: int, device: torch.device) -> torch.Tensor:
    """(N, ps, ps, 3) uint8 patches sliced from a host layer at (N, 2)
    (y, x), by the C++/OpenMP extractor (``native``) where it builds, else
    numpy, uploaded to ``device`` from pinned memory."""
    coords = torch.as_tensor(coords).cpu().numpy()
    pin = device.type == "cuda"
    out = torch.empty((len(coords), ps, ps, 3), dtype=torch.uint8, pin_memory=pin)
    view = out.numpy()
    if data.dtype == np.uint8 and data.shape[-1] == 3 and native.available():
        native.extract_patches_native(data, coords, ps, out=view)
    else:
        for i, (y, x) in enumerate(coords):
            view[i] = data[y : y + ps, x : x + ps]
    return out.to(device, non_blocking=pin)


def _load_layer(path_or_slide, layer: int, mmap_ok: bool = False):
    """Load (or memory-map) a pyramid layer → (array, (h, w)).

    With ``mmap_ok`` and a backend that supports it (Slide.mmap_layer),
    returns the raw mmap array; backends without mmap support materialize
    the layer, with a warning, since that defeats the ONDISK mode."""
    with contextlib.ExitStack() as stack:
        if isinstance(path_or_slide, Slide):
            slide = path_or_slide
        else:
            slide = stack.enter_context(open_slide(path_or_slide))
        h, w = slide.layer_size(layer)
        if mmap_ok:
            arr = slide.mmap_layer(layer)
            if arr is not None:
                return arr, (h, w)
            print(
                "warning: ONDISK mode requested but this slide backend has no "
                "memory-mapped layers; materializing the layer in host RAM."
            )
        return slide.get_region_from_layer(layer, (0, 0), (h, w)), (h, w)


def _gather(image, on_device: bool, coords: torch.Tensor, ps: int, dtype) -> torch.Tensor:
    """Patches at ``coords`` (int32 on the device): uint8 (``dtype`` None) or
    float32 ``u8 · f32(1/255)``; K1 on a device layer, host slices (then the
    same /255 on the device) on a host layer."""
    if on_device:
        if dtype is None:
            one_slide = torch.zeros((coords.shape[0],), dtype=torch.int32, device=coords.device)
            return gather_multi_u8(image[None], one_slide, coords, ps)
        return gather_normalize(image, coords, ps, dtype)
    patches = _host_gather(image, coords, ps, coords.device)
    if dtype is None:
        return patches
    return patches.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32)


def max_coverage_steps(dh: int, dw: int, batch_size: int, patch_size: int,
                       downscale: int, dense_level: int) -> int:
    """Safety bound of the coverage loop: ~4x the batches full coverage
    needs at ``dense_level`` (full.py:211-214, pipeline.py:307-311)."""
    f = coverage_footprint(patch_size, downscale)
    return int(4 * dense_level * dh * dw / max(batch_size * f * f, 1)) + 64


def _rnd_draws(gen: torch.Generator, n_cells: int, batch_size: int, n_jitter: int):
    """The random draws of one coverage step: Gumbel noise over the
    (n_cells,) accumulator cells and a (2, batch_size) jitter in
    [0, n_jitter), both from ``gen`` on its device."""
    noise = gumbel(gen, (n_cells,))
    jitter = torch.randint(0, n_jitter, (2, batch_size), generator=gen, device=gen.device)
    return noise, jitter


def rnd_coords(gen, accum: torch.Tensor, h: int, w: int, batch_size: int, patch_size: int,
               downscale: int, dense_level: int, grid: int = 1) -> torch.Tensor:
    """One step's (batch_size, 2) int32 patch corners on the device: cells
    drawn by ``coverage_cell_topk``, each centred under its patch, jittered
    by [0, downscale) px and clamped into the layer (full.py:111-118). With
    ``grid`` 4 the jitter and the clamp stay on the 4-px grid (the
    PackedSlide branch, pipeline.py:264-273)."""
    ps, d = patch_size, downscale
    noise, jitter = _rnd_draws(gen, accum.shape[0] * accum.shape[1], batch_size, d // grid)
    cy, cx = coverage_cell_topk(noise, accum, dense_level, batch_size)
    pd2 = ps // d // 2
    jitter = jitter.to(cy.device) * grid
    y = ((cy - pd2) * d + jitter[0]).clamp(0, (h - ps) // grid * grid)
    x = ((cx - pd2) * d + jitter[1]).clamp(0, (w - ps) // grid * grid)
    return torch.stack([y, x], dim=1).to(torch.int32)


class FullImageRndSampler:
    """Coverage-guided random tiling of a whole slide
    (reference full_samplers.py:21-299), on ``device`` (the current CUDA
    device by default; ``"cpu"`` runs the plain versions)."""

    def __init__(
        self,
        psimage_path: Path | str | Slide,
        layer: int,
        patch_size: int,
        batch_size: int,
        mode: SamplerExecutionMode = SamplerExecutionMode.INMEMORY_SINGLEPROC,
        dense_level: int = 2,
        speedup: int = 16,
        device=None,
    ):
        self.mode = mode
        self.layer = layer
        self.device = resolve_device(device)
        ondisk = mode == SamplerExecutionMode.ONDISK_MULTIPROC
        data, (self.h, self.w) = _load_layer(psimage_path, layer, mmap_ok=ondisk)
        self.data = data
        self._image, self._on_device = _stage(data, self.device, ondisk)
        self.dh = self.h // speedup
        self.dw = self.w // speedup
        print(f"Image {self.h} x {self.w} at {speedup}x -> {self.dh} x {self.dw}")
        if self.h < patch_size or self.w < patch_size:
            raise ValueError(
                f"layer {layer} size {(self.h, self.w)} is smaller than "
                f"patch_size {patch_size}"
            )
        self.patch_size = patch_size
        self.batch_size = batch_size
        self._downscale = speedup
        self.dense_level = dense_level
        self._filled_ratio: list[float] = []
        self._accum: np.ndarray | None = None
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    def seed(self, seed: int) -> "FullImageRndSampler":
        self._gen.manual_seed(seed)
        return self

    def _batches(self, dtype=None):
        """(patches, coords, filled) per step until full coverage, or the
        safety bound; ``filled`` is read on the host after every step."""
        ps, d = self.patch_size, self._downscale
        accum = torch.zeros((self.dh, self.dw, 1), dtype=torch.float32, device=self.device)
        max_steps = max_coverage_steps(self.dh, self.dw, self.batch_size, ps, d, self.dense_level)
        filled, steps = 0.0, 0
        while filled < 1.0 and steps < max_steps:
            steps += 1
            coords = rnd_coords(self._gen, accum, self.h, self.w, self.batch_size, ps, d,
                                self.dense_level)
            patches = _gather(self._image, self._on_device, coords, ps, dtype)
            accum, fr = accumulate_coverage(accum, coords // d, coverage_footprint(ps, d))
            filled = float(fr)
            self._filled_ratio.append(filled)
            yield patches, coords, filled
        if filled < 1.0:
            print(
                f"warning: coverage loop stopped at filled={filled:.4f} after "
                f"{steps} batches (max_steps={max_steps}) without reaching "
                "full coverage — prediction maps may be incomplete"
            )
        self._accum = accum[..., 0].cpu().numpy()

    def device_generator(self, dtype=None):
        """Device-resident fast path (the JAX ``jax_generator``): yields
        (patches, coords int32, filled) on the sampler's device, patches
        uint8 (K1's uint8 mode) or, with ``dtype=torch.float32``, /255."""
        yield from self._batches(dtype)

    def generator(self) -> Iterator[tuple[list[Patch], float]]:
        """Yield (patches, filled_ratio) until the accumulator is fully
        covered (reference full_samplers.py:263-274)."""
        for patches, coords, filled in self._batches():
            data = patches.cpu().numpy()
            crd = coords.cpu().numpy()
            plist = [
                Patch(layer=self.layer, pos_x=int(crd[i, 1]), pos_y=int(crd[i, 0]),
                      patch_size=self.patch_size, data=data[i])
                for i in range(data.shape[0])
            ]
            yield plist, filled

    def __iter__(self):
        return self.generator()

    def generator_torch(self):
        """(features f32 /255, coords f32, filled_ratio) batches on the
        sampler's device."""
        for patches, coords, filled in self._batches(torch.float32):
            yield patches, coords.to(torch.float32), filled

    # -- diagnostics (reference full_samplers.py:65-70, 292-299) -------------

    def plot_empty_area_history(self, filename: str) -> bool:
        """Plot the filled ratio per step to ``filename``; False (nothing
        written) where matplotlib is not installed."""
        try:
            import matplotlib
        except ImportError:
            return False
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plt.figure()
        plt.plot(self._filled_ratio)
        plt.title("Empty area")
        plt.xlabel("iteration")
        plt.ylabel("empty area percentage")
        plt.savefig(filename, format="jpg", dpi=300)
        plt.close()
        return True

    def visualize_heatmap(self, name: str):
        """The coverage accumulator as a greyscale image at ``name`` (scaled
        to its maximum) and its nonzero mask at ``_<name>`` beside it (at
        quality 98), saved by Pillow in the format of ``name``'s extension,
        as the JAX package saves them."""
        from PIL import Image

        if self._accum is not None:
            a = (self._accum / np.max(self._accum) * 255).astype(np.uint8)
            Image.fromarray(a).save(name)
            a = np.where(a > 0, 255, 0).astype(np.uint8)
            # binary companion image: underscore-prefixed *filename* (the
            # reference prefixes the whole path, full_samplers.py:297-299)
            p = Path(name)
            Image.fromarray(a).save(p.with_name("_" + p.name), quality=98)


class FullImageDenseSampler:
    """Deterministic stride tiling of a whole slide
    (reference full_samplers.py:302-452), on ``device``."""

    def __init__(
        self,
        psimage_path: Path | str | Slide,
        layer: int,
        patch_size: int,
        batch_size: int,
        mode: SamplerExecutionMode = SamplerExecutionMode.INMEMORY_SINGLEPROC,
        stride: int | None = None,
        device=None,
    ):
        self.mode = mode
        self.layer = layer
        self.device = resolve_device(device)
        ondisk = mode == SamplerExecutionMode.ONDISK_MULTIPROC
        data, (self.h, self.w) = _load_layer(psimage_path, layer, mmap_ok=ondisk)
        self.data = data
        self._image, self._on_device = _stage(data, self.device, ondisk)
        if self.h < patch_size or self.w < patch_size:
            raise ValueError(
                f"layer {layer} size {(self.h, self.w)} is smaller than "
                f"patch_size {patch_size}"
            )
        self.patch_size = patch_size
        self.batch_size = batch_size
        self.stride = stride if stride is not None else patch_size
        print(f"Image {self.h} x {self.w}")

    def _create_batched_coords(self) -> list[np.ndarray]:
        """Grid + last-column + last-row + bottom-right corner, batched with
        last-batch padding by repeating the final coord (exact port of
        reference full_samplers.py:374-404)."""
        ps, s = self.patch_size, self.stride
        coords = [
            (y, x)
            for y in range(0, self.h - ps, s)
            for x in range(0, self.w - ps, s)
        ]
        coords += [(y, self.w - ps) for y in range(0, self.h - ps, s)]
        coords += [(self.h - ps, x) for x in range(0, self.w - ps, s)]
        coords.append((self.h - ps, self.w - ps))

        batched = [
            coords[i : i + self.batch_size]
            for i in range(0, len(coords), self.batch_size)
        ]
        while len(batched[-1]) < self.batch_size:
            batched[-1].append(coords[-1])
        return [np.asarray(b, dtype=np.int32) for b in batched]

    def _batches(self, dtype=None):
        batched = self._create_batched_coords()
        n = len(batched)
        for i, c in enumerate(batched):
            coords = torch.from_numpy(c).to(self.device)
            yield _gather(self._image, self._on_device, coords, self.patch_size, dtype), c, i / n

    def device_generator(self, dtype=None):
        """(patches, coords int32 numpy, progress) with the patches on the
        sampler's device, uint8 or, with ``dtype=torch.float32``, /255."""
        yield from self._batches(dtype)

    def generator(self) -> Iterable[tuple[list[Patch], float]]:
        for patches, coords, progress in self._batches():
            data = patches.cpu().numpy()
            plist = [
                Patch(layer=self.layer, pos_x=int(coords[i, 1]), pos_y=int(coords[i, 0]),
                      patch_size=self.patch_size, data=data[i])
                for i in range(data.shape[0])
            ]
            yield plist, progress

    def __iter__(self):
        return self.generator()

    def generator_torch(self):
        """(features f32 /255, coords f32, progress) on the sampler's device."""
        for patches, coords, progress in self._batches(torch.float32):
            yield patches, torch.from_numpy(coords.astype(np.float32)).to(self.device), progress

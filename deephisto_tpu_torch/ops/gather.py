"""Patch gather: N patches at (y, x) coords from a device-resident slide.

Port of ``deephisto_tpu/ops/gather.py`` (the uint8 gathers, plain PyTorch
here) and ``deephisto_tpu/experimental/pallas_gather.py`` (the fused gather +
/255, kernel K1 in ``csrc/gather.cu``). The exact predict path runs K1 in
place of the JAX package's gather followed by ``model_input``: they compute
the same function. The training sampler runs K1's multi-slide uint8 mode
(:func:`gather_multi_u8`, plain version :func:`gather_patches_multi`) where
the JAX package runs ``gather_patches_multi_xla``.

Layouts are the JAX package's: (H, W, C) uint8 slides, (N, 2) int32 (y, x)
coords, (N, ps, ps, C) patches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

KERNEL = "gather_normalize"
KERNEL_MULTI = "gather_multi_u8"
_SIGNATURE = {
    "dh_gather_normalize": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "dh_gather_multi_u8": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
}
_OUT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _start(idx: torch.Tensor, extent: int, size: int) -> torch.Tensor:
    """``lax.dynamic_slice``'s start index: a negative one counts from the
    end, then it is clamped so that the slice fits."""
    return torch.where(idx < 0, idx + extent, idx).clamp(0, extent - size)


def gather_patches(image: torch.Tensor, coords, patch_size: int) -> torch.Tensor:
    """(N, ps, ps, C) uint8 patches from an (H, W, C) image at (N, 2) (y, x).

    Start indices follow ``lax.dynamic_slice``, as in ``gather_patches_xla``:
    negative ones count from the end, and all are clamped into the image."""
    ps = patch_size
    coords = torch.as_tensor(coords, device=image.device).long()
    y = _start(coords[:, 0], image.shape[0], ps)
    x = _start(coords[:, 1], image.shape[1], ps)
    r = torch.arange(ps, device=image.device)
    return image[(y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]]


def gather_patches_multi(
    images: torch.Tensor, slide_idx, coords, patch_size: int
) -> torch.Tensor:
    """Gather from a stack of same-shape slides: images (S, H, W, C) uint8,
    slide_idx (N,), coords (N, 2) → (N, ps, ps, C). Indices follow
    ``lax.dynamic_slice``, as in ``gather_patches_multi_xla``."""
    ps = patch_size
    dev = images.device
    s = _start(torch.as_tensor(slide_idx, device=dev).long(), images.shape[0], 1)
    coords = torch.as_tensor(coords, device=dev).long()
    y = _start(coords[:, 0], images.shape[1], ps)
    x = _start(coords[:, 1], images.shape[2], ps)
    r = torch.arange(ps, device=dev)
    return images[
        s[:, None, None], (y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]
    ]


@functools.lru_cache(maxsize=None)
def u8_table(dtype: torch.dtype) -> torch.Tensor:
    """The 256 values of ``u8 / 255`` in ``dtype``, on the CPU, as the JAX
    package computes them: f32 as the Pallas kernel does (``u8 · f32(1/255)``,
    pallas_gather.py:124), bf16 as ``model_input`` does (``bf16(u8) /
    bf16(255)``, predict/pipeline.py:42)."""
    u = torch.arange(256)
    if dtype == torch.float32:
        return u.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    if dtype == torch.bfloat16:
        return u.to(torch.bfloat16) / torch.tensor(255.0, dtype=torch.bfloat16)
    raise ValueError(f"out_dtype must be float32 or bfloat16, got {dtype}")


@functools.lru_cache(maxsize=None)
def _device_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return u8_table(dtype).to(device)


def gather_normalize_ref(
    image: torch.Tensor, coords, patch_size: int, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """Plain version of K1: gather, then look every byte up in
    :func:`u8_table`."""
    table = u8_table(out_dtype).to(image.device)
    return table[gather_patches(image, coords, patch_size).long()]


def _coords_on(image: torch.Tensor, coords, ps: int) -> torch.Tensor:
    """Check (N, 2) int32 coords against the slide and return them on the
    slide's device. CPU coords are checked on the host and copied without
    waiting (pinned memory makes the copy asynchronous); CUDA coords cost one
    synchronising read of their bounds."""
    coords = torch.as_tensor(coords)
    if coords.dtype != torch.int32 or coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(
            f"coords must be (N, 2) int32, got {tuple(coords.shape)} {coords.dtype}"
        )
    h, w = image.shape[0], image.shape[1]
    if ps < 1 or ps > h or ps > w:
        raise ValueError(f"patch_size {ps} does not fit a {h}x{w} slide")
    if len(coords):
        lo = coords.amin(0).tolist()
        hi = coords.amax(0).tolist()
        if lo[0] < 0 or lo[1] < 0 or hi[0] > h - ps or hi[1] > w - ps:
            raise ValueError(
                f"coords out of range: y in [{lo[0]}, {hi[0]}], x in "
                f"[{lo[1]}, {hi[1]}]; a {ps}-px patch of a {h}x{w} slide needs "
                f"0 <= y <= {h - ps} and 0 <= x <= {w - ps}"
            )
    return coords.to(image.device, non_blocking=True).contiguous()


def gather_normalize(
    image: torch.Tensor, coords, patch_size: int, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """K1: (N, ps, ps, C) patches of ``u8 / 255`` in ``out_dtype`` (float32
    or bfloat16) from an (H, W, C) uint8 contiguous slide at (N, 2) int32
    (y, x) coords. Raises on coords that leave the slide.

    A slide on the CPU takes the plain version; a slide on a CUDA device
    launches the kernel (built at first use), and raises if it cannot."""
    if image.dtype != torch.uint8 or image.ndim != 3:
        raise ValueError(
            f"image must be (H, W, C) uint8, got {tuple(image.shape)} {image.dtype}"
        )
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if out_dtype not in _OUT_BYTES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    coords = _coords_on(image, coords, patch_size)
    if image.device.type == "cpu":
        return gather_normalize_ref(image, coords, patch_size, out_dtype)
    if image.device.type != "cuda":
        raise ValueError(f"gather_normalize runs on cpu or cuda, not {image.device}")

    n, ps, c = coords.shape[0], patch_size, image.shape[2]
    out = torch.empty((n, ps, ps, c), dtype=out_dtype, device=image.device)
    table = _device_table(out_dtype, image.device)
    lib = _build.load("gather", _SIGNATURE)
    err = lib.dh_gather_normalize(
        image.device.index, image.data_ptr(), image.shape[1], c,
        coords.data_ptr(), n, ps, table.data_ptr(), _OUT_BYTES[out_dtype],
        out.data_ptr(), torch.cuda.current_stream(image.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out


def gather_multi_u8(images: torch.Tensor, slide_idx, coords, patch_size: int) -> torch.Tensor:
    """K1, multi-slide uint8 mode: (N, ps, ps, C) uint8 windows from an
    (S, H, W, C) uint8 contiguous bank at (N,) int32 slide indices and (N, 2)
    int32 (y, x) coords, the start indices clamped as ``lax.dynamic_slice``
    clamps them (as :func:`gather_patches_multi`, its plain version). The
    kernel clamps on the card, so coords on the card are never read back.

    A bank on the CPU takes the plain version; a bank on a CUDA device
    launches the kernel (built at first use), and raises if it cannot."""
    if images.dtype != torch.uint8 or images.ndim != 4:
        raise ValueError(
            f"images must be (S, H, W, C) uint8, got {tuple(images.shape)} {images.dtype}"
        )
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    s, h, w, c = images.shape
    if patch_size < 1 or patch_size > h or patch_size > w:
        raise ValueError(f"patch_size {patch_size} does not fit a {h}x{w} bank")
    slide_idx = torch.as_tensor(slide_idx)
    coords = torch.as_tensor(coords)
    n = coords.shape[0] if coords.ndim == 2 else -1
    if (coords.dtype != torch.int32 or coords.ndim != 2 or coords.shape[1] != 2
            or slide_idx.dtype != torch.int32 or slide_idx.shape != (n,)):
        raise ValueError(
            f"slide_idx must be (N,) int32 and coords (N, 2) int32, got "
            f"{tuple(slide_idx.shape)} {slide_idx.dtype} and {tuple(coords.shape)} {coords.dtype}"
        )
    if images.device.type == "cpu":
        return gather_patches_multi(images, slide_idx, coords, patch_size)
    if images.device.type != "cuda":
        raise ValueError(f"gather_multi_u8 runs on cpu or cuda, not {images.device}")
    dev = images.device
    slide_idx = slide_idx.to(dev, non_blocking=True).contiguous()
    coords = coords.to(dev, non_blocking=True).contiguous()
    out = torch.empty((n, patch_size, patch_size, c), dtype=torch.uint8, device=dev)
    lib = _build.load("gather", _SIGNATURE)
    err = lib.dh_gather_multi_u8(
        dev.index, images.data_ptr(), s, h, w, c, slide_idx.data_ptr(),
        coords.data_ptr(), n, patch_size, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, KERNEL_MULTI)
    _build.count_launch(KERNEL_MULTI)
    return out

"""Patch gather: N patches at (y, x) coords from a device-resident slide.

Port of ``deephisto_tpu/ops/gather.py`` (the uint8 gathers, plain PyTorch
here) and ``deephisto_tpu/experimental/pallas_gather.py`` (the fused gather +
/255, kernel K1 in ``csrc/gather.cu``). The exact predict path runs K1 in
place of the JAX package's gather followed by ``model_input``: they compute
the same function. The training sampler runs K1's multi-slide uint8 mode
(:func:`gather_multi_u8`, plain version :func:`gather_patches_multi`) where
the JAX package runs ``gather_patches_multi_xla``. Both int8 predicts run
K1's int8 mode (:func:`gather_quantize_int8`): the same gather, each byte
quantized through the int8 model's table and written in the layout its stem
takes (:func:`s2d_pack4`, or :func:`unpack_s2d8` of an fcn "s2d8" staging).

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
KERNEL_INT8 = "gather_quantize_int8"
# K1's int8 layouts, as the kernel's Int8Layout enum numbers them
INT8_LAYOUTS = {"hwc": 0, "s2d4": 1, "s2d8_to_s2d4": 2}
_SMEM_LIMIT = 227 * 1024  # a block's dynamic shared memory on Hopper (csrc/gather.cu)
_SLOT_TARGET = 12288  # input bytes a slot of K1's int8 ring holds, at most about
_SIGNATURE = {
    "dh_gather_normalize": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "dh_gather_multi_u8": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
    "dh_gather_quantize_int8": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
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
    """Check that ``coords`` are (N, 2) int32 and that a ps-px patch fits
    the slide, and return them on the slide's device. Their values are not
    read, so CUDA coords cost no synchronising read: the kernel clamps them
    as :func:`_start` does."""
    coords = torch.as_tensor(coords)
    if coords.dtype != torch.int32 or coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(
            f"coords must be (N, 2) int32, got {tuple(coords.shape)} {coords.dtype}"
        )
    h, w = image.shape[0], image.shape[1]
    if ps < 1 or ps > h or ps > w:
        raise ValueError(f"patch_size {ps} does not fit a {h}x{w} slide")
    return coords.to(image.device, non_blocking=True).contiguous()


def gather_normalize(
    image: torch.Tensor, coords, patch_size: int, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """K1: (N, ps, ps, C) patches of ``u8 / 255`` in ``out_dtype`` (float32
    or bfloat16) from an (H, W, C) uint8 contiguous slide at (N, 2) int32
    (y, x) coords, the start indices clamped as ``lax.dynamic_slice`` clamps
    them in ``gather_patches_xla``: a negative one counts from the end, then
    the patch is moved inside the slide (as :func:`gather_patches`).

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
        image.device.index, image.data_ptr(), image.shape[0], image.shape[1], c,
        coords.data_ptr(), n, ps, table.data_ptr(), _OUT_BYTES[out_dtype],
        out.data_ptr(), torch.cuda.current_stream(image.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out


def _bank_args(images: torch.Tensor, slide_idx, coords, patch_size: int):
    """Check a multi-slide gather's bank, indices and window size; returns
    (slide_idx, coords, n) as tensors where they were given."""
    if images.dtype != torch.uint8 or images.ndim != 4:
        raise ValueError(
            f"images must be (S, H, W, C) uint8, got {tuple(images.shape)} {images.dtype}"
        )
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    h, w = images.shape[1], images.shape[2]
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
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on cpu or cuda, not {images.device}")
    return slide_idx, coords, n


def gather_multi_u8(images: torch.Tensor, slide_idx, coords, patch_size: int) -> torch.Tensor:
    """K1, multi-slide uint8 mode: (N, ps, ps, C) uint8 windows from an
    (S, H, W, C) uint8 contiguous bank at (N,) int32 slide indices and (N, 2)
    int32 (y, x) coords, the start indices clamped as ``lax.dynamic_slice``
    clamps them (as :func:`gather_patches_multi`, its plain version). The
    kernel clamps on the card, so coords on the card are never read back.

    A bank on the CPU takes the plain version; a bank on a CUDA device
    launches the kernel (built at first use), and raises if it cannot."""
    slide_idx, coords, n = _bank_args(images, slide_idx, coords, patch_size)
    if images.device.type == "cpu":
        return gather_patches_multi(images, slide_idx, coords, patch_size)
    s, h, w, c = images.shape
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


def s2d_pack4(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → the 4×4 space-to-depth form (B, H/4, W/4, 16C),
    channel (ry·4 + rx)·C + c, as the s2d stem packs its input."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 4, w // 4, 16 * c)


def unpack_s2d8(x: torch.Tensor) -> torch.Tensor:
    """(B, H/8, W/8, 4·48) "s2d8" input, channel (si·2 + sj)·48 + c4 → the
    4×4 form (B, H/4, W/4, 48): one reshape (the math of the JAX package's
    ``pre_packed="s2d8"``, not its layout)."""
    b, h8, w8, c = x.shape
    x = x.reshape(b, h8, w8, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h8, 2 * w8, c // 4)


def _int8_args(images, lut, layout: str, patch_size: int) -> None:
    """Refuse what K1's int8 mode does not take."""
    if layout not in INT8_LAYOUTS:
        raise ValueError(f"layout must be one of {tuple(INT8_LAYOUTS)}, got {layout!r}")
    if not isinstance(lut, torch.Tensor) or lut.dtype != torch.int8 or lut.shape != (256,):
        raise ValueError("lut must be a (256,) int8 tensor")
    c = images.shape[3]
    if layout == "s2d4" and patch_size % 4:
        raise ValueError(f"the s2d4 layout needs patch_size % 4 == 0, got {patch_size}")
    if layout == "s2d8_to_s2d4" and c != 192:
        raise ValueError(f"the s2d8_to_s2d4 layout takes 192-channel s2d8 cells, got {c}")
    if not int8_launch_plan(images, layout, patch_size)["smem"]:
        raise ValueError(f"a cell of a {patch_size}x{c} window does not fit K1's int8 block")


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def int8_plan(layout: str, patch_size: int, channels: int, box: bool = True) -> dict:
    """How K1's int8 mode cuts its windows, as ``csrc/gather.cu:plan_int8``
    does. A group is the ``rows`` input rows one run of output is made from
    (4 for s2d4, else 1), ``groups`` a window; each group is cut into
    ``parts`` of ``per_part`` units (4×4 cells, 16-byte chunks or s2d8
    cells), so that a part's row fits a TMA box (``box``: 2 KB of 8-byte
    elements; else a bulk copy a row) and a slot holds about 12 KB; an item
    is ``per_item`` groups of one part, its rows staged ``row_pitch`` bytes
    apart; ``stages`` slots (16 consumer warps, up to 8 slots each, within
    192 KB); ``smem``, the bytes of shared memory a block asks for, 0 where
    the cut does not fit."""
    pad = 15  # a row's staged bytes start up to 15 bytes early, at a 16-byte boundary
    rows = 4 if layout == "s2d4" else 1
    unit = {"s2d4": 4 * channels, "hwc": 16, "s2d8_to_s2d4": channels}[layout]
    units = {"s2d4": patch_size // 4, "hwc": -(-patch_size * channels // 16),
             "s2d8_to_s2d4": patch_size}[layout]
    groups = patch_size // 4 if layout == "s2d4" else patch_size
    target = min(_SLOT_TARGET // rows, 2048 - pad if box else 1 << 31)
    parts = -(-units // max(1, target // unit))
    per_part = -(-units // parts)
    row_pitch = _align(per_part * unit + pad, 16)
    per_item = max(1, min(groups, 32 // rows, _SLOT_TARGET // (rows * row_pitch)))
    slot = _align(per_item * rows * row_pitch, 128)
    stages = 16 * max(1, min(8, 192 * 1024 // (16 * slot)))
    smem = _align(stages * (2 * 8 + 56), 128) + stages * slot + 256 * 32 * 4
    if (box and row_pitch > 2048) or smem > _SMEM_LIMIT:
        smem = 0
    return {"box": box, "rows": rows, "groups": groups, "parts": parts, "per_part": per_part,
            "per_item": per_item, "row_pitch": row_pitch, "stages": stages, "smem": smem}


def int8_launch_plan(images: torch.Tensor, layout: str, patch_size: int) -> dict:
    """The :func:`int8_plan` that K1's int8 mode launches on ``images``, as
    ``dh_gather_quantize_int8`` picks it: a box where the bank's rows and
    base are 16-byte aligned and the box's columns and rows fit the bank,
    else a bulk copy a row."""
    s, h, w, c = images.shape
    plan = int8_plan(layout, patch_size, c, box=True)
    if ((w * c) % 16 or images.data_ptr() % 16 or not plan["smem"] or plan["row_pitch"] > w * c
            or plan["per_item"] * plan["rows"] > s * h):
        plan = int8_plan(layout, patch_size, c, box=False)
    return plan


def gather_quantize_int8_ref(images: torch.Tensor, slide_idx, coords, patch_size: int,
                             lut: torch.Tensor, layout: str) -> torch.Tensor:
    """Plain version of K1's int8 mode: :func:`gather_patches_multi`, every
    byte looked up in ``lut``, then the layout (:func:`s2d_pack4`,
    :func:`unpack_s2d8`), made contiguous."""
    x = lut.to(images.device)[gather_patches_multi(images, slide_idx, coords, patch_size).long()]
    if layout == "s2d4":
        x = s2d_pack4(x)
    elif layout == "s2d8_to_s2d4":
        x = unpack_s2d8(x)
    return x.contiguous()


def gather_quantize_int8(images: torch.Tensor, slide_idx, coords, patch_size: int,
                         lut: torch.Tensor, layout: str) -> torch.Tensor:
    """K1, int8 mode: the windows of :func:`gather_multi_u8` (an (S, H, W,
    C) uint8 contiguous bank, (N,) int32 slide indices, (N, 2) int32 (y, x)
    coords, starts clamped as ``lax.dynamic_slice`` clamps them), each byte
    ``u`` replaced by ``lut[u]`` (a (256,) int8 table: the int8 model's
    input quantize, ``QuantizedResNet.input_lut``), written in ``layout``:

    * ``"hwc"``: (N, ps, ps, C), the window as it is;
    * ``"s2d4"``: (N, ps/4, ps/4, 16C), the s2d stem's 4×4 form
      (:func:`s2d_pack4`; ps % 4 == 0);
    * ``"s2d8_to_s2d4"``: a window of (ps, ps, 192) "s2d8" cells as the 4×4
      form (N, 2ps, 2ps, 48) (:func:`unpack_s2d8`).

    A bank on the CPU takes the plain version
    (:func:`gather_quantize_int8_ref`); a bank on a CUDA device launches the
    kernel (built at first use), and raises if it cannot."""
    slide_idx, coords, n = _bank_args(images, slide_idx, coords, patch_size)
    _int8_args(images, lut, layout, patch_size)
    if images.device.type == "cpu":
        return gather_quantize_int8_ref(images, slide_idx, coords, patch_size, lut, layout)
    s, h, w, c = images.shape
    ps = patch_size
    dev = images.device
    if lut.device != dev:
        raise ValueError(f"lut is on {lut.device}, the bank on {dev}")
    lut = lut.contiguous()
    slide_idx = slide_idx.to(dev, non_blocking=True).contiguous()
    coords = coords.to(dev, non_blocking=True).contiguous()
    shape = {"hwc": (n, ps, ps, c), "s2d4": (n, ps // 4, ps // 4, 16 * c),
             "s2d8_to_s2d4": (n, 2 * ps, 2 * ps, c // 4)}[layout]
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    lib = _build.load("gather", _SIGNATURE)
    err = lib.dh_gather_quantize_int8(
        dev.index, images.data_ptr(), s, h, w, c, slide_idx.data_ptr(), coords.data_ptr(),
        n, ps, lut.data_ptr(), INT8_LAYOUTS[layout], out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, KERNEL_INT8)
    _build.count_launch(KERNEL_INT8)
    return out

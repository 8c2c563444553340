"""Attention over (B, H, N, Dh) heads, the layout of
``deephisto_tpu/models/vit.py:_attention``.

``flash_attention`` is kernel K3 (``csrc/attention.cu``), the port of the
Pallas TPU flash-attention forward that the JAX ViT runs from
``FLASH_MIN_SEQ`` tokens up; ``flash_attention_ref`` is its plain version.
``attention_plain`` is the port of the jnp branch the JAX ViT runs below
that length (vit.py:135-137): it is what XLA ran there, not a kernel's plain
version, and it rounds where that branch does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

KERNEL = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_SIGNATURE = {
    "dh_flash_attention": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
}


def flash_attention_ref(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K3, with the TPU kernel's precision: Q·Kᵀ in f32,
    scaled in f32, softmax statistics in f32, P cast to V's dtype before
    P·V, P·V accumulated in f32 and normalised by the f32 row sum, the
    output in Q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def attention_plain(q, k, v) -> torch.Tensor:
    """The JAX ViT's jnp attention (vit.py:135-137), line for line: Q·Kᵀ in
    the input dtype, times the scale in the input dtype, softmax in f32 and
    back, then P·V in the input dtype."""
    scale = q.shape[-1] ** -0.5
    attn = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, H, N, Dh), got {tuple(t.shape)}")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"q, k and v must share shape, dtype and device; got q "
                f"{tuple(q.shape)} {q.dtype} {q.device}, {name} {tuple(t.shape)} "
                f"{t.dtype} {t.device}"
            )
    if q.dtype not in _ELEM_BYTES:
        raise ValueError(f"flash_attention takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes Dh in {HEAD_DIMS}, got {q.shape[-1]}")


def _check_layout(name: str, t: torch.Tensor) -> None:
    """What the kernel reads: unit stride along Dh and, for bf16 (16-byte
    cp.async rows), a 16-byte aligned base and strides of 8 elements."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride along Dh, got strides {t.stride()}")
    if t.dtype == torch.bfloat16 and (
        t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
    ):
        raise ValueError(
            f"bfloat16 {name} needs a 16-byte aligned base and strides that are "
            f"multiples of 8 elements, got strides {t.stride()}"
        )


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """K3: non-causal ``softmax(q·kᵀ·scale)·v`` over (B, H, N, Dh) heads,
    bfloat16 or float32, Dh in 16/32/64/128, scale > 0. q, k and v may be
    strided views (such as slices of one qkv projection) with unit stride
    along Dh.

    Tensors on the CPU take the plain version; tensors on a CUDA device
    launch the kernel (built at first use) and raise if they cannot. The
    result has shape (B, H, N, Dh) and lies in (B, N, H, Dh) memory, so
    ``out.transpose(1, 2).reshape(B, N, H * Dh)`` is a view."""
    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention takes a scale > 0, got {scale}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)

    b, h, n, dh = q.shape
    out = torch.empty((b, n, h, dh), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    lib = _build.load("attention", _SIGNATURE)
    err = lib.dh_flash_attention(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, n, dh, _ELEM_BYTES[q.dtype], strides, float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out

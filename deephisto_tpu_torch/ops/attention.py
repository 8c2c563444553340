"""Attention over (B, H, N, Dh) heads, the layout of
``deephisto_tpu/models/vit.py:_attention``.

``flash_attention`` is kernel K3 (``csrc/attention.cu``), the port of the
Pallas TPU flash-attention forward that the JAX ViT runs from
``FLASH_MIN_SEQ`` tokens up, as a ``torch.autograd.Function`` whose backward
is kernels K4 (dK, dV) and K5 (dQ) of ``csrc/attention_bwd.cu``, the ports of
the Pallas TPU backward kernels that the JAX ViT reaches under grad.
``flash_attention_ref`` and ``flash_attention_bwd_ref`` are their plain
versions. ``attention_plain`` is the port of the jnp branch the JAX ViT runs
below that length (vit.py:135-137): it is what XLA ran there, not a kernel's
plain version, and it rounds where that branch does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

KERNEL = "flash_attention"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_DQ = "flash_attention_bwd_dq"
HEAD_DIMS = (16, 32, 64, 128)
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {
    "dh_flash_attention": [
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P,
    ]
}
_BWD_SIGNATURE = {
    "dh_flash_attention_bwd_dkv": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P,
    ],
    "dh_flash_attention_bwd_dq": [
        _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P,
    ],
}


def flash_attention_ref(q, k, v, scale: float, return_lse: bool = False):
    """Plain version of K3, with the TPU kernel's precision: Q·Kᵀ in f32,
    scaled in f32, softmax statistics in f32, P cast to V's dtype before
    P·V, P·V accumulated in f32 and normalised by the f32 row sum, the
    output in Q's dtype. With ``return_lse`` also each row's f32 log-sum-exp
    of the scaled scores, (B, H, N), the residual of the backward."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale: float):
    """Plain version of K4 and K5: (dq, dk, dv) of ``flash_attention`` at
    output ``o`` with residual ``lse`` and output gradient ``do``, with the
    TPU backward kernels' precision (flash_attention.py:894-919): S = Q·Kᵀ in
    f32 times the scale in f32, P = exp(S - lse) in f32, P cast to dO's dtype
    before Pᵀ·dO, dP = dO·Vᵀ in f32, di = Σ O∘dO in f32, dS = (dP - di)∘P·scale
    cast to the inputs' dtype before dSᵀ·Q and dS·K, every product summed in
    f32, the gradients in the inputs' dtype."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    ds = (dp - di) * p * scale
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), qf)
    dq = torch.matmul(ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3])
    )


def _forward(q, k, v, scale: float, with_lse: bool):
    """K3 on the card (with the lse residual when ``with_lse``), its plain
    version on the CPU. Returns (out, lse or None)."""
    dev = q.device
    if dev.type == "cpu":
        if with_lse:
            return flash_attention_ref(q, k, v, scale, return_lse=True)
        return flash_attention_ref(q, k, v, scale), None
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)

    b, h, n, dh = q.shape
    out = torch.empty((b, n, h, dh), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev) if with_lse else None
    lib = _build.load("attention", _SIGNATURE)
    err = lib.dh_flash_attention(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, h, n, dh, _ELEM_BYTES[q.dtype],
        _strides(q, k, v, out), float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out, lse


def _bwd_launch(kernel: str, q, k, v, do, lse, di, grads, scale: float) -> None:
    """One launch of K4 (``grads`` = (dk, dv)) or K5 (``grads`` = (dq,))."""
    dev = q.device
    b, h, n, dh = q.shape
    lib = _build.load("attention_bwd", _BWD_SIGNATURE)
    fn = lib.dh_flash_attention_bwd_dkv if kernel == KERNEL_DKV else lib.dh_flash_attention_bwd_dq
    err = fn(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), *(g.data_ptr() for g in grads), b, h, n, dh, _ELEM_BYTES[q.dtype],
        _strides(q, k, v, do, *grads), float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, kernel)
    _build.count_launch(kernel)


def _bwd_operands(q, k, v, o, lse, do):
    """Checks the backward's operands on the card and returns (do, lse, di)
    as the kernels read them: dO with unit stride along Dh and 16-byte rows
    (copied if autograd handed over another layout), lse contiguous, and
    di = Σ O∘dO (f32, (B, H, N)), a torch op as on the TPU (an XLA op)."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q: got {tuple(do.shape)} {do.dtype} {do.device}"
        )
    if do.stride(-1) != 1 or (
        do.dtype == torch.bfloat16 and (do.data_ptr() % 16 or any(s % 8 for s in do.stride()[:3]))
    ):
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    di = (o.float() * do.float()).sum(dim=-1).contiguous()
    return do, lse.contiguous(), di


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """K4 and K5: (dq, dk, dv) of ``flash_attention`` at output ``o`` with
    the lse residual of K3 and the output gradient ``do``. Tensors on the CPU
    take :func:`flash_attention_bwd_ref`; on the card K4 writes dK and dV and
    K5 dQ, all three into one (B, N, 3, H, Dh) buffer, the layout of the
    ViT's qkv projection; the gradients are views of it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
    do, lse, di = _bwd_operands(q, k, v, o, lse, do)
    b, h, n, dh = q.shape
    grads = torch.empty((b, n, 3, h, dh), dtype=q.dtype, device=q.device)
    dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
    _bwd_launch(KERNEL_DKV, q, k, v, do, lse, di, (dk, dv), scale)
    _bwd_launch(KERNEL_DQ, q, k, v, do, lse, di, (dq,), scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward K3 with the lse residual, backward K4 + K5 (the plain
    versions of all three for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """K3: non-causal ``softmax(q·kᵀ·scale)·v`` over (B, H, N, Dh) heads,
    bfloat16 or float32, Dh in 16/32/64/128, scale > 0. q, k and v may be
    strided views (such as slices of one qkv projection) with unit stride
    along Dh. Differentiable: when a gradient is wanted, K3 also writes the
    lse residual and the backward runs K4 and K5.

    Tensors on the CPU take the plain versions; tensors on a CUDA device
    launch the kernels (built at first use) and raise if they cannot. The
    result has shape (B, H, N, Dh) and lies in (B, N, H, Dh) memory, so
    ``out.transpose(1, 2).reshape(B, N, H * Dh)`` is a view."""
    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention takes a scale > 0, got {scale}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, with_lse=False)[0]

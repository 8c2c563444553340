"""The SwiGLU gate of a packed fc1 output: kernel K7 (``csrc/swiglu.cu``)
and its plain version.

The UNI2-h ViT's MLP (timm's ``SwiGLUPacked``: ``GluMlp`` with SiLU and the
gate first) projects each token to 2h values with one ``fc1`` and gates
them: ``silu(u[..., :h]) * u[..., h:]``, into ``fc2``. :func:`swiglu` is the
gate on a tensor of any device: on the card K7, one pass in float32 that
rounds once; on the CPU :func:`swiglu_ref`. The JAX package has no gated
MLP, so K7 replaces no TPU kernel.

K7's backward is :func:`swiglu_bwd_ref` as torch ops (no training path
runs it on the card yet; an eval forward records no graph).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

KERNEL = "swiglu"
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_SIGNATURE = {
    "dh_swiglu": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p]
}


def _halves(u: torch.Tensor) -> int:
    if u.ndim < 1 or u.shape[-1] % 2:
        raise ValueError(f"the gate takes a last axis of 2h values, got {tuple(u.shape)}")
    return u.shape[-1] // 2


def swiglu_ref(u: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: ``silu(a) * b`` of the halves ``a``, ``b`` of
    ``u``'s last axis, in float32 (or ``u``'s wider type), rounded once to
    ``u``'s dtype."""
    h = _halves(u)
    acc = torch.promote_types(u.dtype, torch.float32)
    a, b = u[..., :h].to(acc), u[..., h:].to(acc)
    return (F.silu(a) * b).to(u.dtype)


def swiglu_bwd_ref(u: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`swiglu_ref` with respect to ``u``, given the
    output's: ``grad·b·σ(a)(1 + a(1 − σ(a)))`` for ``a`` and
    ``grad·silu(a)`` for ``b``, in float32 (or ``u``'s wider type), in
    ``u``'s dtype."""
    h = _halves(u)
    acc = torch.promote_types(u.dtype, torch.float32)
    a, b, g = u[..., :h].to(acc), u[..., h:].to(acc), grad.to(acc)
    s = torch.sigmoid(a)
    return torch.cat([g * b * s * (1 + a * (1 - s)), g * a * s], dim=-1).to(u.dtype)


def _launch(u: torch.Tensor) -> torch.Tensor:
    dev = u.device
    if u.dtype not in _ELEM_BYTES:
        raise ValueError(f"K7 takes bfloat16 or float32, got {u.dtype}")
    h = _halves(u)
    if (h * _ELEM_BYTES[u.dtype]) % 16:
        raise ValueError(f"K7 reads 16-byte vectors: h = {h} {u.dtype} values is not a whole "
                         "number of them")
    u = u.contiguous()
    if u.data_ptr() % 16:
        raise ValueError("K7 reads 16-byte vectors: the input must start on a 16-byte boundary")
    rows = u.numel() // (2 * h)
    out = torch.empty((*u.shape[:-1], h), dtype=u.dtype, device=dev)
    lib = _build.load("swiglu", _SIGNATURE)
    err = lib.dh_swiglu(dev.index, u.data_ptr(), out.data_ptr(), rows, h,
                        _ELEM_BYTES[u.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return _launch(u)

    @staticmethod
    def backward(ctx, grad):
        (u,) = ctx.saved_tensors
        return swiglu_bwd_ref(u, grad)


def swiglu(u: torch.Tensor) -> torch.Tensor:
    """K7: ``silu(u[..., :h]) * u[..., h:]`` of a (..., 2h) bf16 or f32
    tensor, as (..., h) in its dtype. A tensor on the CPU takes
    :func:`swiglu_ref`; on a CUDA device the kernel runs (built at first
    use) or the call raises. Differentiable (its backward as torch ops)."""
    dev = u.device
    if dev.type == "cpu":
        return swiglu_ref(u)
    if dev.type != "cuda":
        raise ValueError(f"swiglu runs on cpu or cuda, not {dev}")
    if torch.is_grad_enabled() and u.requires_grad:
        return _SwiGLU.apply(u)
    return _launch(u)

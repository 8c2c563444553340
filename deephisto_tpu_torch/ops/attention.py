"""Attention over (B, H, N, Dh) heads, the layout of
``deephisto_tpu/models/vit.py:_attention``.

``flash_attention`` is kernel K3 (``csrc/attention.cu``), the port of the
Pallas TPU flash-attention forward that the JAX ViT runs from
``FLASH_MIN_SEQ`` tokens up, as a ``torch.autograd.Function`` whose backward
is kernels K5 (dQ, and the row sums di = Σ O∘dO) and K4 (dK, dV) of
``csrc/attention_bwd.cu``, the ports of the Pallas TPU backward kernels that
the JAX ViT reaches under grad; :func:`attention_design` names the design
all three take for a dtype and head width.
``flash_attention_ref`` and ``flash_attention_bwd_ref`` are their plain
versions. ``attention_plain`` is the port of the jnp branch the JAX ViT runs
below that length (vit.py:135-137): it is what XLA ran there, not a kernel's
plain version, and it rounds where that branch does.

K3's inference form is also the registered op ``deephisto::flash_attention``
(qkv, scale) → out, so that ``torch.export`` can carry it (``export.py``): a
launch through ``data_ptr()`` cannot run on the FakeTensors of a trace. The
ViT's wrapper, :func:`flash_attention_qkv`, enters it only while tracing
(``torch.compiler.is_compiling()``), whatever the tensors' device, so that
a CPU export records the same node; its CUDA implementation is the launch
below, its CPU one the plain version. Eager calls keep the direct launch,
with no dispatcher hop.
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
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P,
    ]
}
_BWD_SIGNATURE = {
    "dh_flash_attention_bwd_dkv": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P,
    ],
    "dh_flash_attention_bwd_dq": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P,
    ],
}
# the attention kernels' designs, by the codes of csrc/flash_common.cuh:Design
DESIGNS = {"simt": 0, "mma.sync": 1, "wgmma": 2}
_TILE = 64  # rows of the kernels' tiles: the di buffer is padded to a multiple


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
    the input dtype, times the scale in the input dtype (the Python float
    rounded to it first, as JAX's weak typing does: at Dh 32 or 128 a bf16
    1/√Dh is not the f32 one), softmax in f32 and back, then P·V in the
    input dtype."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)
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


def _rows_16b(t: torch.Tensor) -> bool:
    """bf16 rows as the kernels copy them (16-byte cp.async and TMA): a
    16-byte aligned base and strides of 8 elements."""
    return t.dtype != torch.bfloat16 or not (
        t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
    )


def _check_layout(name: str, t: torch.Tensor) -> None:
    """What the kernel reads: unit stride along Dh and, for bf16, 16-byte
    rows (:func:`_rows_16b`)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride along Dh, got strides {t.stride()}")
    if not _rows_16b(t):
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
        DESIGNS[attention_design(q.dtype, dh)], _strides(q, k, v, out), float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out, lse


def attention_design(dtype: torch.dtype, dh: int) -> str:
    """The design of K3, K4 and K5 for inputs of ``dtype`` and head width
    ``dh``: ``"wgmma"`` for bf16 at Dh 64 (the ViT-S and ViT-B head width),
    ``"mma.sync"`` for bf16 at Dh 16, 32 and 128, ``"simt"`` for f32. The
    one place the choice is made: the launches pass it to the kernels' entry
    points, which refuse a design that has no kernel for the dtype and Dh."""
    if dtype not in _ELEM_BYTES or dh not in HEAD_DIMS:
        raise ValueError(f"flash attention and its backward take bfloat16 or float32 at "
                         f"Dh in {HEAD_DIMS}, got {dtype} at Dh {dh}")
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if dh == 64 else "mma.sync"


def _bwd_launch(kernel: str, q, k, v, do, o, lse, di, grads, scale: float) -> None:
    """One launch of K5 (``grads`` = (dq,); it also writes ``di``) or K4
    (``grads`` = (dk, dv); it reads ``di`` and not ``o``)."""
    dev = q.device
    b, h, n, dh = q.shape
    lib = _build.load("attention_bwd", _BWD_SIGNATURE)
    design = DESIGNS[attention_design(q.dtype, dh)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == KERNEL_DQ:
        (dq,) = grads
        err = lib.dh_flash_attention_bwd_dq(
            dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, h, n, dh, _ELEM_BYTES[q.dtype],
            design, _strides(q, k, v, do, dq, o), float(scale), stream,
        )
    else:
        dk, dv = grads
        err = lib.dh_flash_attention_bwd_dkv(
            dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, dh, _ELEM_BYTES[q.dtype],
            design, _strides(q, k, v, do, dk, dv), float(scale), stream,
        )
    _build.check(lib, err, kernel)
    _build.count_launch(kernel)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride along Dh and 16-byte rows, copied if autograd
    or the caller handed over another layout."""
    return t if t.stride(-1) == 1 and _rows_16b(t) else t.contiguous()


def _bwd_operands(q, k, v, o, lse, do):
    """Checks the backward's operands on the card and returns (do, o, lse,
    di) as the kernels read them: dO and O with unit stride along Dh and
    16-byte rows, lse contiguous, and the f32 (B, H, N64) buffer, N rounded
    up to a multiple of 64, into which K5 writes di = Σ O∘dO (0 past N) for
    K4 to read."""
    for name, t in (("do", do), ("o", o)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q: got {tuple(t.shape)} {t.dtype} {t.device}"
            )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    b, h, n, _ = q.shape
    di = torch.empty((b, h, -(-n // _TILE) * _TILE), dtype=torch.float32, device=q.device)
    return _kernel_layout(do), _kernel_layout(o), lse.contiguous(), di


def _bwd_qkv(q, k, v, o, lse, do, scale: float) -> torch.Tensor:
    """K5 then K4 on the card, writing dQ, dK and dV into one
    (B, N, 3, H, Dh) buffer, the layout of the ViT's qkv projection, which
    is returned."""
    do, o, lse, di = _bwd_operands(q, k, v, o, lse, do)
    b, h, n, dh = q.shape
    grads = torch.empty((b, n, 3, h, dh), dtype=q.dtype, device=q.device)
    dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
    _bwd_launch(KERNEL_DQ, q, k, v, do, o, lse, di, (dq,), scale)
    _bwd_launch(KERNEL_DKV, q, k, v, do, o, lse, di, (dk, dv), scale)
    return grads


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """K4 and K5: (dq, dk, dv) of ``flash_attention`` at output ``o`` with
    the lse residual of K3 and the output gradient ``do``. Tensors on the CPU
    take :func:`flash_attention_bwd_ref`; on the card K5 writes dQ and di,
    then K4 dK and dV, all three gradients into one (B, N, 3, H, Dh) buffer,
    the layout of the ViT's qkv projection; the gradients are views of it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
    grads = _bwd_qkv(q, k, v, o, lse, do, scale)
    return tuple(grads[:, :, i].transpose(1, 2) for i in range(3))


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


def _split_qkv(qkv):
    """The (B, H, N, Dh) q, k and v views of a (B, N, 3, H, Dh) tensor."""
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


class _FlashAttentionQKV(torch.autograd.Function):
    """K3 on the q, k and v views of one (B, N, 3, H, Dh) qkv tensor; the
    backward returns the buffer K5 and K4 fill as the gradient of qkv, as
    it is: no selects, zeros or copies (the plain versions, stacked, for CPU
    tensors)."""

    @staticmethod
    def forward(ctx, qkv, scale):
        q, k, v = _split_qkv(qkv)
        out, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        q, k, v = _split_qkv(qkv)
        if qkv.device.type == "cpu":
            grads = flash_attention_bwd_ref(q, k, v, out, lse, do, ctx.scale)
            return torch.stack([g.transpose(1, 2) for g in grads], dim=2), None
        return _bwd_qkv(q, k, v, out, lse, do, ctx.scale), None


def _attention_out(qkv: torch.Tensor) -> torch.Tensor:
    """K3's output for a (B, N, 3, H, Dh) qkv: (B, H, N, Dh) in (B, N, H, Dh)
    memory."""
    b, n, _, h, dh = qkv.shape
    return qkv.new_empty((b, n, h, dh)).transpose(1, 2)


@torch.library.custom_op("deephisto::flash_attention", mutates_args=(), device_types="cuda")
def _flash_attention_op(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """K3's inference launch on the (B, N, 3, H, Dh) qkv, as a registered op."""
    return _forward(*_split_qkv(qkv), scale, with_lse=False)[0]


@_flash_attention_op.register_kernel("cpu")
def _flash_attention_op_cpu(qkv, scale):
    out = _attention_out(qkv)
    out.copy_(flash_attention_ref(*_split_qkv(qkv), scale))
    return out


@_flash_attention_op.register_fake
def _flash_attention_op_fake(qkv, scale):
    return _attention_out(qkv)


def flash_attention_qkv(qkv, scale: float) -> torch.Tensor:
    """K3 over the heads of one (B, N, 3, H, Dh) qkv projection (flax's
    column order, ``qkv[:, :, 0]`` the queries): the value of
    :func:`flash_attention` on its three (B, H, N, Dh) views. Under grad
    the gradient of ``qkv`` is the one (B, N, 3, H, Dh) buffer that K5 and
    K4 write, handed to autograd as it is."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, Dh), got {tuple(qkv.shape)}")
    q, k, v = _split_qkv(qkv)
    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention takes a scale > 0, got {scale}")
    if torch.compiler.is_compiling():
        return torch.ops.deephisto.flash_attention(qkv, float(scale))
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashAttentionQKV.apply(qkv, scale)
    return _forward(q, k, v, scale, with_lse=False)[0]


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

"""A residual add and the LayerNorm after it: kernel K8
(``csrc/layernorm.cu``) and its plain versions.

A pre-norm ViT block adds each branch to the residual stream and normalises
the sum for the next branch. :func:`add_layernorm` does both in one pass on
the card: ``s = x + r`` (or ``x + γ⊙r``, LayerScale) rounded once to the
activation dtype, and ``y``, the LayerNorm of ``s`` with float32 statistics
and affine, rounded once; :func:`layernorm` is the LayerNorm alone. On the
CPU, and under ``torch.export`` or ``torch.compile`` (which record the plain
ops), they run :func:`add_layernorm_ref` and :func:`layernorm_ref`: today's
``+`` or ``torch.addcmul``, then ``F.layer_norm`` on ``s.float()`` cast back,
as ``models.vit._LayerNorm`` computes it. The JAX package has no such kernel:
XLA fused its LayerNorm.

K8 has no backward: it takes no tensor that requires grad while grad is on.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

KERNEL = "layernorm"
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
MAX_ROW_BYTES = 32 * 16 * 16  # 32 lanes × 16 vectors of 16 bytes, held in registers
_SIGNATURE = {
    "dh_add_layernorm": [ctypes.c_int, *[ctypes.c_void_p] * 7, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
}


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain version of the LayerNorm alone: ``F.layer_norm`` over the last
    axis of ``x.float()``, rounded to ``x``'s dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(x.dtype)


def add_layernorm_ref(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float,
                      gamma: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: ``s = x + r``, or ``torch.addcmul(x, gamma, r)``,
    then ``(s, layernorm_ref(s, weight, bias, eps))``."""
    s = x + r if gamma is None else torch.addcmul(x, gamma, r)
    return s, layernorm_ref(s, weight, bias, eps)


def _check(x, r, weight, bias, gamma) -> None:
    """Raise ``ValueError`` on what K8 does not take."""
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"K8 takes bfloat16 or float32 activations, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] % 8:
        raise ValueError(f"K8 reads 16-byte vectors of rows whose width is a multiple of 8, "
                         f"got shape {tuple(x.shape)}")
    dim = x.shape[-1]
    if dim * _ELEM_BYTES[x.dtype] > MAX_ROW_BYTES:
        raise ValueError(f"K8 holds a row in one warp's registers, at most {MAX_ROW_BYTES} "
                         f"bytes; a row of {dim} {x.dtype} is wider")
    named = [("x", x, x.shape, x.dtype), ("weight", weight, (dim,), torch.float32),
             ("bias", bias, (dim,), torch.float32)]
    if r is not None:
        named.append(("r", r, x.shape, x.dtype))
    if gamma is not None:
        named.append(("gamma", gamma, (dim,), x.dtype))
    for name, t, shape, dtype in named:
        if t.device != x.device:
            raise ValueError(f"K8: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"K8 takes {name} as {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K8 takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"K8 reads 16-byte vectors: {name} must start on a 16-byte "
                             "boundary")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t, _, _ in named):
        raise ValueError("K8 has no backward: call it with grad off, or take the plain version")


def _launch(x, r, weight, bias, eps, gamma):
    _check(x, r, weight, bias, gamma)
    dev = x.device
    dim = x.shape[-1]
    y = torch.empty_like(x)
    s = None if r is None else torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load(KERNEL, _SIGNATURE)
    err = lib.dh_add_layernorm(dev.index, x.data_ptr(), ptr(r), ptr(gamma), weight.data_ptr(),
                               bias.data_ptr(), ptr(s), y.data_ptr(), x.numel() // dim, dim,
                               _ELEM_BYTES[x.dtype], eps,
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return s, y


def _plain(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain versions: on the CPU, or while
    ``torch.export``/``torch.compile`` trace; a CUDA tensor otherwise
    launches K8, any other device raises."""
    if x.device.type == "cpu" or torch.compiler.is_compiling():
        return True
    if x.device.type != "cuda":
        raise ValueError(f"K8 runs on cpu or cuda, not {x.device}")
    return False


def add_layernorm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float, gamma: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: ``(s, y)`` for ``s = x + r`` (``x + gamma⊙r`` with LayerScale's
    ``gamma``, in ``x``'s dtype) and ``y`` its LayerNorm over the last axis
    with float32 ``weight`` and ``bias``. ``x`` and ``r``: (..., dim) bf16 or
    f32, contiguous, 16-byte aligned, dim a multiple of 8. A CPU tensor takes
    :func:`add_layernorm_ref`; on a CUDA device the kernel runs (built at
    first use) or the call raises."""
    if _plain(x):
        return add_layernorm_ref(x, r, weight, bias, eps, gamma)
    return _launch(x, r, weight, bias, eps, gamma)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """K8 without the residual: the LayerNorm of ``x`` over its last axis,
    as :func:`add_layernorm` forms ``y``. A CPU tensor takes
    :func:`layernorm_ref`."""
    if _plain(x):
        return layernorm_ref(x, weight, bias, eps)
    return _launch(x, None, weight, bias, eps, None)[1]

"""int8 convolution with its per-output-channel f32 epilogue, kernel K6
(``csrc/conv_int8.cu``).

Port of the inner convs of ``deephisto_tpu/models/quantize.py:
QuantizedResNet.apply`` (``conv_s32`` / ``conv_f32`` / ``conv_to_int8``,
:460-481), which XLA lowered on the TPU: an NHWC s8 × s8 → s32 convolution,
then, per output channel c,

* :func:`conv_f32`: ``y·a[c] + b[c]`` in f32 (``a`` the dequant scale, ``b``
  the folded bias);
* :func:`conv_to_int8`: ``round(relu(y·a[c] + b[c]))`` clipped to ±127, as
  int8 (``a = dequant·inv``, ``b = bias·inv`` with ``inv`` the next layer's
  input scale, both formed in f32 by the caller as the JAX package forms
  them), rounding half to even as ``jnp.round``.

The product and the sum are two f32 roundings, never one fused multiply-add,
and the s32 sum is rounded to f32 to nearest, as XLA converts it.

Layouts: x (N, H, W, Cin) int8 contiguous; w (Cout, KH, KW, Cin) int8
contiguous (the JAX package's HWIO kernel transposed once, when the model
is built); pads ((top, bottom), (left, right)) as XLA's explicit padding;
the output (N, OH, OW, Cout) contiguous.

:func:`conv_int8_ref` is the plain version: ``F.conv2d`` in float64 on the
integer values (exact: |y| ≤ 127²·K < 2⁵³, where float32 is not, as
127²·4608 > 2²⁴), cast to int32, then the epilogue as separate torch ops in
the source's order. Tensors on the CPU take it; CUDA tensors launch K6.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

KERNEL = "conv_int8"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {
    "dh_conv_int8": [
        _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P,
    ]
}


def out_extent(n: int, k: int, stride: int, pad: tuple[int, int]) -> int:
    """Output extent of one axis: ``(n + lo + hi - k) // stride + 1``."""
    return (n + pad[0] + pad[1] - k) // stride + 1


def conv_s32_ref(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """The s8 × s8 → s32 convolution, (N, OH, OW, Cout) int32: float64
    ``conv2d`` on the integer values, exact."""
    (pt, pb), (pl, pr) = pads
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    y = F.conv2d(xd, w.permute(0, 3, 1, 2).double(), stride=stride)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_int8_ref(x, w, stride: int, pads, a, b, to_int8: bool) -> torch.Tensor:
    """Plain version of K6 (module docstring)."""
    y = conv_s32_ref(x, w, stride, pads).to(torch.float32)
    y = y * a + b
    if not to_int8:
        return y
    return torch.clamp(torch.round(torch.relu(y)), -127, 127).to(torch.int8)


def _check(x, w, stride, pads, a, b) -> tuple[int, int]:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, Cin) int8, got {tuple(x.shape)} {x.dtype}")
    if w.dtype != torch.int8 or w.ndim != 4 or w.shape[3] != x.shape[3]:
        raise ValueError(
            f"w must be (Cout, KH, KW, Cin={x.shape[3]}) int8, got {tuple(w.shape)} {w.dtype}"
        )
    cout = w.shape[0]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (cout,):
            raise ValueError(f"{name} must be ({cout},) float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if stride < 1 or any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"bad stride {stride} or pads {pads}")
    oh = out_extent(x.shape[1], w.shape[1], stride, pads[0])
    ow = out_extent(x.shape[2], w.shape[2], stride, pads[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"a {tuple(w.shape[1:3])} kernel does not fit {tuple(x.shape[1:3])} "
                         f"padded by {pads}")
    return oh, ow


def conv_int8(x, w, stride: int, pads, a, b, to_int8: bool) -> torch.Tensor:
    """K6 (module docstring): f32 output, or with ``to_int8`` the relu +
    requantized int8 output. CPU tensors take :func:`conv_int8_ref`; CUDA
    tensors launch the kernel (built at first use) and raise if they
    cannot."""
    pads = tuple(tuple(int(p) for p in pair) for pair in pads)
    oh, ow = _check(x, w, stride, pads, a, b)
    if x.device.type == "cpu":
        return conv_int8_ref(x, w, stride, pads, a, b, to_int8)
    if x.device.type != "cuda":
        raise ValueError(f"conv_int8 runs on cpu or cuda, not {x.device}")
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    out = torch.empty((n, oh, ow, cout), device=x.device,
                      dtype=torch.int8 if to_int8 else torch.float32)
    lib = _build.load("conv_int8", _SIGNATURE)
    err = lib.dh_conv_int8(
        x.device.index, x.data_ptr(), n, h, wd, cin, w.data_ptr(), cout, kh, kw, stride,
        pads[0][0], pads[1][0], oh, ow, a.data_ptr(), b.data_ptr(), int(to_int8),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)
    return out


def conv_f32(x, w, stride: int, pads, dequant, bias) -> torch.Tensor:
    """``conv_s32(x, w)·dequant + bias`` in f32 (quantize.py:467-471), K6."""
    return conv_int8(x, w, stride, pads, dequant, bias, to_int8=False)


def conv_to_int8(x, w, stride: int, pads, a, b) -> torch.Tensor:
    """``clip(round(relu(conv_s32(x, w)·a + b)), ±127)`` as int8
    (quantize.py:473-481), K6."""
    return conv_int8(x, w, stride, pads, a, b, to_int8=True)

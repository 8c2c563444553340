"""Shared plain helpers of the reference: float32 without TF32, SAME
padding, NHWC convolutions and the exact integer convolution."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# Rows of an integer convolution's im2col operand per `torch._int_mm` call:
# bounds the operand's memory on the card (≈ 0.6 GB at K = 4608).
_INT_MM_ROWS = 1 << 17


@contextlib.contextmanager
def precise():
    """float32 matmuls and convolutions in float32, not TF32, inside the
    block; the caller's settings are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA SAME padding of one axis: output ceil(n / s), the total padding
    split with the smaller half first."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME convolution of an NHWC float tensor with an OIHW kernel."""
    k = w_oihw.shape[2]
    (pt, pb), (pl, pr) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    return F.conv2d(xc, w_oihw, stride=stride).permute(0, 2, 3, 1)


def im2col(x: torch.Tensor, k: int, stride: int, pads) -> torch.Tensor:
    """(M, k·k·C) operand of an NHWC convolution, columns ordered (kh, kw, c)."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    n, hp, wp, c = xp.shape
    oh, ow = (hp - k) // stride + 1, (wp - k) // stride + 1
    cols = [xp[:, r:r + stride * (oh - 1) + 1:stride, s:s + stride * (ow - 1) + 1:stride]
            for r in range(k) for s in range(k)]
    return torch.cat(cols, dim=-1).reshape(n * oh * ow, k * k * c), (n, oh, ow)


def int_conv(x8: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """The exact integer SAME convolution of (N, H, W, Cin) integer values
    with a (Cout, KH, KW, Cin) integer kernel: (N, OH, OW, Cout) int32. On
    the card an im2col and ``torch._int_mm`` (int32 sums); elsewhere a
    float64 convolution, exact since every sum is below 2^53."""
    k = wq.shape[1]
    pads = (same_pads(x8.shape[1], k, stride), same_pads(x8.shape[2], k, stride))
    if x8.is_cuda:
        wt = wq.reshape(wq.shape[0], -1).to(torch.int8).t()
        n = x8.shape[0]
        rows_per_image = -(-x8.shape[1] // stride) * -(-x8.shape[2] // stride)
        step = max(1, _INT_MM_ROWS // rows_per_image)
        outs = []
        for i in range(0, n, step):
            cols, (b, oh, ow) = im2col(x8[i:i + step].to(torch.int8), k, stride, pads)
            if cols.shape[0] <= 16:  # _int_mm takes more than 16 rows
                cols = F.pad(cols, (0, 0, 0, 17 - cols.shape[0]))
            y = torch._int_mm(cols, wt)[: b * oh * ow]
            outs.append(y.reshape(b, oh, ow, -1))
        return torch.cat(outs)
    (pt, pb), (pl, pr) = pads
    xd = F.pad(x8.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    y = F.conv2d(xd, wq.permute(0, 3, 1, 2).double(), stride=stride)
    return y.round().to(torch.int32).permute(0, 2, 3, 1)


def s2d4(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H/4, W/4, 16C), channel (ry·4 + rx)·C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 4, w // 4, 16 * c)

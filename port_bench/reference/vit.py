"""Plain reference of the ViT patch classifier (Dosovitskiy et al.,
arXiv:2010.11929, at DINO's ViT-S/8 sizes, arXiv:2104.14294), NHWC input,
from a raw state dict and the configuration's sizes (``patch``, ``dim``,
``heads``, ``depth``), of the names ``embed``, ``pos_embed``,
``block{i}.ln1``, ``.attn.qkv``, ``.attn.proj``, ``.ln2``, ``.fc1``,
``.fc2``, ``ln`` and ``head``.

The patchify stem (a patch×patch conv at stride patch, with bias), the
position embedding added, pre-norm blocks (LayerNorm eps 1e-6; multi-head
attention with scale dh^-0.5 and the qkv columns ordered (3, heads, dh);
an MLP with GELU's tanh form), the final LayerNorm, the token mean (no
class token) and the linear head. ``mm`` is the matrix product every
layer takes: float32 for the reference, :func:`fp8_mm` for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale for the tensor (its absmax
    at the format's largest value), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of the two operands rounded to float8 e4m3, summed in
    float32, as an fp8 GEMM computes it."""
    return _fp8(a) @ _fp8(b)


def _linear(x, sd, name, mm):
    return mm(x, sd[f"{name}.weight"].float().t()) + sd[f"{name}.bias"].float()


def _ln(x, sd, name):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"].float(),
                        sd[f"{name}.bias"].float(), 1e-6)


def forward(sd: dict, cfg: dict, x: torch.Tensor, mm=f32_mm, pooled: bool = False):
    """float32 logits (B, classes) of (B, H, W, 3) float images in [0, 1];
    with ``pooled`` the (B, dim) token mean the head takes."""
    p, dim, heads = cfg["patch"], cfg["dim"], cfg["heads"]
    b, h, w, c = x.shape
    gh, gw = h // p, w // p
    patches = x.float().reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    patches = patches.reshape(b * gh * gw, c * p * p)  # (c, kh, kw) order, as OIHW
    wk = sd["embed.weight"].float().reshape(dim, -1)
    t = mm(patches, wk.t()) + sd["embed.bias"].float()
    t = t.reshape(b, gh * gw, dim) + sd["pos_embed"].float()
    dh = dim // heads
    for i in range(cfg["depth"]):
        pre = f"block{i}"
        y = _ln(t, sd, f"{pre}.ln1")
        qkv = _linear(y, sd, f"{pre}.attn.qkv", mm).reshape(b, -1, 3, heads, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # (B, H, N, dh)
        att = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        o = mm(att, v).transpose(1, 2).reshape(b, -1, dim)
        t = t + _linear(o, sd, f"{pre}.attn.proj", mm)
        y = _ln(t, sd, f"{pre}.ln2")
        y = F.gelu(_linear(y, sd, f"{pre}.fc1", mm), approximate="tanh")
        t = t + _linear(y, sd, f"{pre}.fc2", mm)
    f = _ln(t, sd, "ln").mean(dim=1)
    if pooled:
        return f
    return f @ sd["head.weight"].float().t() + sd["head.bias"].float()

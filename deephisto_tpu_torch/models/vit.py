"""Vision Transformer patch classifier, a port of
``deephisto_tpu/models/vit.py`` (``_attention``, ``MHA``, ``Block``, ``ViT``).

Module and parameter names follow the flax model (``embed``, ``pos_embed``,
``stem_conv{i}``, ``stem_bn{i}``, ``stem_gn{i}``, ``block{i}.ln1``,
``block{i}.attn.qkv``, ``block{i}.attn.proj``, ``ln2``, ``fc1``, ``fc2``,
``ln``, ``head``), so :func:`..convert.flax_vit_to_torch` maps one onto the
other by name. The call takes NHWC input, as the JAX model does.

Attention dispatches as the JAX model does: from ``FLASH_MIN_SEQ`` tokens up
on the card it runs kernel K3 (``ops.attention.flash_attention``), where the
JAX model runs the Pallas flash kernel on the TPU; everywhere else the port
of the jnp branch (``ops.attention.attention_plain``).

Numerics follow flax: LayerNorm and GroupNorm use eps 1e-6 and reduce in
float32 on model-dtype activations; the stem's BatchNorm uses eps 1e-5;
``nn.gelu`` is the tanh approximation; convs pad as XLA's ``SAME``; Dense and
Conv layers run in the model dtype on float32 parameters cast at each call,
as flax holds and casts its params; the head is f32 on the model-dtype token
mean.

Attention is differentiable on both routes: K3's backward is kernels K4 and
K5 (``ops.attention.flash_attention`` is a ``torch.autograd.Function``), the
plain branch is plain ops. ``pos_embed`` fixes the token count to that of
``img_size``, as flax fixes it to the init input's.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_plain, flash_attention
from .resnet import BatchNorm, SameConv2d, cast_param

# From this many tokens the JAX model takes the Pallas flash kernel on the
# TPU (deephisto_tpu/models/vit.py:56); the port takes K3 on the card.
FLASH_MIN_SEQ = 512


def _attention(q, k, v, use_flash: bool) -> torch.Tensor:
    """(B, H, N, Dh) attention: kernel K3 when ``use_flash``, else the jnp
    branch's port."""
    if use_flash:
        return flash_attention(q, k, v, q.shape[-1] ** -0.5)
    return attention_plain(q, k, v)


class _SameConvBias(SameConv2d):
    """flax ``nn.Conv`` with its default bias: the SAME conv, then ``+ bias``
    in the activation dtype, as flax adds it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return super().forward(x) + cast_param(self, "bias", x.dtype).view(1, -1, 1, 1)


class _LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics and affine in float32,
    the result in the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class _GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` over channels-last groups of an NCHW view: eps
    1e-6, float32 statistics, the result in the input dtype."""

    def __init__(self, groups: int, ch: int):
        super().__init__(groups, ch, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class _Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 kernel and bias cast to the
    input's (the model) dtype at each call."""

    def forward(self, x):
        return F.linear(x, cast_param(self, "weight", x.dtype), cast_param(self, "bias", x.dtype))


class MHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = _Dense(dim, 3 * dim)
        self.proj = _Dense(dim, dim)

    def forward(self, x):
        b, n, _ = x.shape
        # flax's column order: (3, heads, dh) within each token's 3·dim row
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, self.dim // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = _attention(q, k, v, use_flash=q.is_cuda and n >= FLASH_MIN_SEQ)
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dim))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = _LayerNorm(dim)
        self.attn = MHA(dim, heads)
        self.ln2 = _LayerNorm(dim)
        self.fc1 = _Dense(dim, dim * mlp_ratio)
        self.fc2 = _Dense(dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(y)


class ViT(nn.Module):
    """Compact ViT for patch classification, as the flax ``ViT``.

    stem: "linear" (one patch×patch SAME conv with bias), "conv" (log2(patch)
    3×3 stride-2 SAME convs + BatchNorm + ReLU, then a 1×1 conv with bias) or
    "conv_gn" (the same with GroupNorm of gcd(32, ch) groups). ``img_size``
    is the square input extent the token count (and ``pos_embed``) is built
    for."""

    def __init__(
        self,
        num_classes: int,
        patch: int = 16,
        dim: int = 384,
        depth: int = 6,
        heads: int = 6,
        dtype: torch.dtype = torch.bfloat16,
        stem: str = "linear",
        img_size: int = 224,
    ):
        super().__init__()
        if stem not in ("linear", "conv", "conv_gn"):
            raise ValueError(f"stem must be 'linear', 'conv' or 'conv_gn', got {stem!r}")
        self.num_classes, self.patch, self.dim = num_classes, patch, dim
        self.depth, self.heads, self.dtype, self.stem = depth, heads, dtype, stem
        side = img_size
        if stem == "linear":
            self.embed = _SameConvBias(3, dim, patch, patch)
            side = -(-side // patch)
        else:
            n_down = patch.bit_length() - 1
            if 1 << n_down != patch:
                raise ValueError(f"conv stem needs a power-of-2 patch, got {patch}")
            self.n_down = n_down
            cin = 3
            for i in range(n_down):
                ch = max(dim >> (n_down - 1 - i), 32)
                self.add_module(f"stem_conv{i}", SameConv2d(cin, ch, 3, 2))
                if stem == "conv_gn":
                    self.add_module(f"stem_gn{i}", _GroupNorm(math.gcd(32, ch), ch))
                else:
                    self.add_module(f"stem_bn{i}", BatchNorm(ch))
                cin = ch
                side = -(-side // 2)
            self.embed = _SameConvBias(cin, dim, 1)
        self.n_tokens = side * side
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n_tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads))
        self.ln = _LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)

    def forward(self, x, tokens: bool = False):
        """x: (B, H, W, C) images, or with ``tokens=True`` stem features
        (B, gh, gw, dim) that enter at the transformer (the JAX model's
        serving entry for a stem run outside it). Returns (B, num_classes)
        float32 logits."""
        x = x.to(self.dtype)
        if not tokens:
            x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC (channels_last) memory
            if self.stem != "linear":
                norm = "stem_gn" if self.stem == "conv_gn" else "stem_bn"
                for i in range(self.n_down):
                    x = getattr(self, f"stem_conv{i}")(x)
                    x = F.relu(getattr(self, f"{norm}{i}")(x))
            x = self.embed(x).permute(0, 2, 3, 1)
        b, gh, gw, d = x.shape
        x = x.reshape(b, gh * gw, d) + cast_param(self, "pos_embed", self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.ln(x).mean(dim=1)
        return self.head(x.float())


ViTSmall = partial(ViT, dim=384, depth=6, heads=6)
ViTBase = partial(ViT, dim=768, depth=12, heads=12)

"""Patch-classifier model factory, a port of
``deephisto_tpu/models/patch_cls_simple/model.py`` for the ResNet and ViT
families.

Loading torchvision's pretrained weights is not ported yet (ROADMAP, queue A
item 7); :func:`init_model` makes random weights from a seed."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..resnet import BasicBlock, Bottleneck, ResNet, build_resnet
from ..vit import ViT


def get_model(
    n_classes: int,
    depth: int = 18,
    dtype: torch.dtype = torch.bfloat16,
    stem: str = "imagenet",
    arch: str = "resnet",
    width: int = 1,
    patch: int = 16,
    input_size: int = 224,
) -> ResNet | ViT:
    """Classifier backbone with an ``n_classes`` head, built on the CPU
    (move it with ``.to(device)``).

    arch="resnet": ResNet of ``depth`` (18/34/50/101), ``stem`` "imagenet"
    or "s2d", channel counts times ``width``.
    arch="vit": ViT-S width (dim 384, 6 heads) with ``depth`` transformer
    blocks (1..12), ``patch``-px tokens and stem "linear" ("imagenet" maps
    to it), "conv" or "conv_gn"; its token count is that of an
    ``input_size``² input (the JAX ``init_model``'s ``input_size``)."""
    if arch == "vit":
        if not 1 <= depth <= 12:
            raise ValueError(
                f"arch='vit' supports depth 1..12 transformer blocks, got "
                f"{depth}; set model.depth explicitly for ViT configs"
            )
        vit_stem = "linear" if stem == "imagenet" else stem
        if vit_stem not in ("linear", "conv", "conv_gn"):
            raise ValueError(
                f"arch='vit' supports stem 'linear' (imagenet), 'conv', or "
                f"'conv_gn', got {stem!r} (resnet-only stems like 's2d' do "
                "not apply)"
            )
        return ViT(num_classes=n_classes, depth=depth, dtype=dtype, patch=patch,
                   stem=vit_stem, img_size=input_size)
    if arch != "resnet":
        raise ValueError(f"arch must be 'resnet' or 'vit', got {arch!r}")
    return build_resnet(n_classes, depth=depth, dtype=dtype, stem=stem, width=width)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # flax's default kernel init: truncated normal on [-2, 2] std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    with torch.no_grad():
        w.copy_(t * std)


@torch.no_grad()
def init_model(model: ResNet | ViT, seed: int = 0) -> ResNet | ViT:
    """Random weights from ``torch.Generator().manual_seed(seed)``, with the
    flax model's scheme: lecun-normal convs and Dense layers, zero biases,
    norm scales 1 and biases 0; for the ResNet, scale 0 on each block's last
    BN (``bn2``/``bn3``); for the ViT, ``pos_embed`` normal(0, 0.02).
    Initialises in place and returns the model."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
    if isinstance(model, ViT):
        model.pos_embed.copy_(torch.randn(model.pos_embed.shape, generator=gen) * 0.02)
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.bn2.weight.zero_()
        elif isinstance(m, Bottleneck):
            m.bn3.weight.zero_()
    return model

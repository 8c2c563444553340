"""Patch-classifier model factory, a port of
``deephisto_tpu/models/patch_cls_simple/model.py`` for the ResNet family.

Loading torchvision's pretrained weights is not ported yet (ROADMAP, queue A
item 6); :func:`init_model` makes random weights from a seed."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..resnet import BasicBlock, Bottleneck, ResNet, build_resnet


def get_model(
    n_classes: int,
    depth: int = 18,
    dtype: torch.dtype = torch.bfloat16,
    stem: str = "imagenet",
    arch: str = "resnet",
    width: int = 1,
) -> ResNet:
    """Classifier backbone with an ``n_classes`` head: ResNet of ``depth``
    (18/34/50/101), ``stem`` "imagenet" or "s2d", channel counts times
    ``width``. Built on the CPU; move it with ``.to(device)``."""
    if arch == "vit":
        raise NotImplementedError(
            "arch='vit' is not ported yet (ROADMAP, queue A item 11: ViT family)"
        )
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
def init_model(model: ResNet, seed: int = 0) -> ResNet:
    """Random weights from ``torch.Generator().manual_seed(seed)``, with the
    flax model's scheme: lecun-normal convs and fc, zero fc bias, BN scale 1
    and bias 0, and scale 0 on each block's last BN (``bn2``/``bn3``).
    Initialises in place and returns the model."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.bn2.weight.zero_()
        elif isinstance(m, Bottleneck):
            m.bn3.weight.zero_()
    return model

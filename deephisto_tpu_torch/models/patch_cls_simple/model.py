"""Patch-classifier model factory, a port of
``deephisto_tpu/models/patch_cls_simple/model.py`` for the ResNet and ViT
families: :func:`init_model` makes random weights from a seed and, with
``pretrained``, loads torchvision's ImageNet weights from a local file where
one exists (nothing is downloaded)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..resnet import BasicBlock, Bottleneck, ResNet, build_resnet, load_torchvision_weights
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
    in_channels: int = 3,
) -> ResNet | ViT:
    """Classifier backbone with an ``n_classes`` head, built on the CPU
    (move it with ``.to(device)``).

    arch="resnet": ResNet of ``depth`` (18/34/50/101), ``stem`` "imagenet"
    or "s2d", channel counts times ``width``, ``in_channels`` input channels
    (9 for the multi-magnification configuration).
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
        if in_channels != 3:
            raise ValueError("arch='vit' takes RGB input only")
        return ViT(num_classes=n_classes, depth=depth, dtype=dtype, patch=patch,
                   stem=vit_stem, img_size=input_size)
    if arch != "resnet":
        raise ValueError(f"arch must be 'resnet' or 'vit', got {arch!r}")
    return build_resnet(n_classes, depth=depth, dtype=dtype, stem=stem, width=width,
                        in_channels=in_channels)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # flax's default kernel init: truncated normal on [-2, 2] std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    with torch.no_grad():
        w.copy_(t * std)


def _model_depth(model: ResNet) -> int:
    basic = isinstance(getattr(model, model.stages[0][0]), BasicBlock)
    if model.stage_sizes == (2, 2, 2, 2):
        return 18
    if model.stage_sizes == (3, 4, 6, 3):
        return 34 if basic else 50
    return 101


@torch.no_grad()
def init_model(model: ResNet | ViT, seed: int = 0, pretrained: bool = False) -> ResNet | ViT:
    """Random weights from ``torch.Generator().manual_seed(seed)``, with the
    flax model's scheme: lecun-normal convs and Dense layers, zero biases,
    norm scales 1 and biases 0; for the ResNet, scale 0 on each block's last
    BN (``bn2``/``bn3``); for the ViT, ``pos_embed`` normal(0, 0.02).

    ``pretrained``: then, under the JAX ``init_model``'s rule (a ResNet with
    the imagenet stem, width 1 and 3 input channels), torchvision's ImageNet
    weights are loaded into the backbone from torch hub's cache
    (:func:`~..resnet.load_torchvision_weights`), the ``fc``
    kept random; it prints which weights the model starts from.
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
    if (pretrained and isinstance(model, ResNet) and model.stem == "imagenet"
            and model.num_filters == 64 and model.in_channels == 3):
        depth = _model_depth(model)
        if load_torchvision_weights(model, depth) is not None:
            print(f"Loaded torchvision ImageNet weights into the ResNet-{depth} backbone.")
        else:
            print(f"No local torchvision ResNet-{depth} weights (resnet{depth}-*.pth under "
                  f"torch.hub.get_dir()/checkpoints); random weights from seed {seed}.")
    return model

"""Model zoo: the ResNet and ViT families and the flax → torch weight bridge."""

from .convert import flax_resnet_to_torch, flax_vit_to_torch
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    build_resnet,
)
from .vit import ViT, ViTBase, ViTSmall

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "build_resnet",
    "ViT",
    "ViTBase",
    "ViTSmall",
    "flax_resnet_to_torch",
    "flax_vit_to_torch",
]

"""Model zoo: the ResNet family and the flax → torch weight bridge."""

from .convert import flax_resnet_to_torch
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

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "build_resnet",
    "flax_resnet_to_torch",
]

"""Model zoo: the ResNet and ViT families (UNI2-h among the ViTs), the ViT's
folded-stem serving form, int8 PTQ of both families, and the flax ↔ torch
weight bridge."""

from .convert import (
    flax_folded_stem_to_torch,
    flax_qvariables_to_torch,
    flax_resnet_to_torch,
    flax_vit_qvariables_to_torch,
    flax_vit_to_torch,
    torch_to_flax,
)
from .quantize import QuantizedResNet, quantize_resnet
from .quantize_vit import QuantizedViT, calibrate_vit, quantize_vit
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
from .vit import UNI2h, FoldedStemViT, RegViT, ViT, ViTBase, ViTSmall, fold_vit_stem


def quantize_model(model, calib_batches):
    """Family-dispatching PTQ entry point (deephisto_tpu/models/__init__.py:9):
    a ViT goes to :func:`quantize_vit`, a ResNet to :func:`quantize_resnet`."""
    if isinstance(model, ViT):
        return quantize_vit(model, calib_batches)
    return quantize_resnet(model, calib_batches)

__all__ = [
    "BasicBlock",
    "FoldedStemViT",
    "QuantizedResNet",
    "QuantizedViT",
    "RegViT",
    "Bottleneck",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "build_resnet",
    "calibrate_vit",
    "fold_vit_stem",
    "quantize_model",
    "quantize_resnet",
    "quantize_vit",
    "ViT",
    "ViTBase",
    "ViTSmall",
    "flax_folded_stem_to_torch",
    "flax_qvariables_to_torch",
    "flax_resnet_to_torch",
    "flax_vit_qvariables_to_torch",
    "flax_vit_to_torch",
    "torch_to_flax",
    "UNI2h",
]

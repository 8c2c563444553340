"""Model zoo: the ResNet and ViT families, int8 PTQ of the ResNet, and the
flax → torch weight bridge."""

from .convert import flax_qvariables_to_torch, flax_resnet_to_torch, flax_vit_to_torch
from .quantize import QuantizedResNet, quantize_resnet
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


def quantize_model(model, calib_batches):
    """Family-dispatching PTQ entry point (deephisto_tpu/models/__init__.py:9):
    a ResNet goes to :func:`quantize_resnet`. The ViT's W8A8 quantization is
    not ported yet (ROADMAP, queue A item 4) and raises."""
    if isinstance(model, ViT):
        raise NotImplementedError(
            "quantize_vit is not ported yet (ROADMAP, queue A item 4: the rest of the ViT "
            "family); only the ResNet family quantizes"
        )
    return quantize_resnet(model, calib_batches)

__all__ = [
    "BasicBlock",
    "QuantizedResNet",
    "Bottleneck",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "build_resnet",
    "quantize_model",
    "quantize_resnet",
    "ViT",
    "ViTBase",
    "ViTSmall",
    "flax_qvariables_to_torch",
    "flax_resnet_to_torch",
    "flax_vit_to_torch",
]

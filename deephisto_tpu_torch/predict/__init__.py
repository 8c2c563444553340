"""Full-WSI prediction: the exact dense path and the fcn serving mode."""

from .fcn import (
    FcnStagedSlide,
    fcn_equivalent_patches,
    predict_full_fcn,
    s2d_pack_image,
    stage_for_fcn,
    tile_logits,
)
from .pipeline import (
    PackedSlide,
    dense_coords,
    model_input,
    predict_full_fused,
    stage_packed_slide,
)

__all__ = [
    "FcnStagedSlide",
    "PackedSlide",
    "dense_coords",
    "fcn_equivalent_patches",
    "model_input",
    "predict_full_fcn",
    "predict_full_fused",
    "s2d_pack_image",
    "stage_for_fcn",
    "stage_packed_slide",
    "tile_logits",
]

"""Full-WSI prediction: the exact dense path, the coverage-random path, the
fcn serving mode, and the sampler-driven predictors and visualizations of
the predict CLI."""

from .fcn import (
    FcnStagedSlide,
    fcn_equivalent_patches,
    predict_full_fcn,
    s2d_pack_image,
    stage_for_fcn,
    tile_logits,
)
from .full_patched import (
    ImagePredictorPatched,
    batch_predictor,
    load_model,
    perform_and_save_visualizations,
    process_on_device,
)
from .pipeline import (
    PackedSlide,
    dense_coords,
    model_input,
    predict_full_fused,
    predict_full_random_fused,
    stage_packed_slide,
)

__all__ = [
    "FcnStagedSlide",
    "ImagePredictorPatched",
    "PackedSlide",
    "batch_predictor",
    "dense_coords",
    "fcn_equivalent_patches",
    "load_model",
    "model_input",
    "perform_and_save_visualizations",
    "predict_full_fcn",
    "predict_full_fused",
    "predict_full_random_fused",
    "process_on_device",
    "s2d_pack_image",
    "stage_for_fcn",
    "stage_packed_slide",
    "tile_logits",
]

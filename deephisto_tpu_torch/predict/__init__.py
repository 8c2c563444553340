"""Full-WSI prediction: the exact dense path."""

from .pipeline import dense_coords, model_input, predict_full_fused

__all__ = ["dense_coords", "model_input", "predict_full_fused"]

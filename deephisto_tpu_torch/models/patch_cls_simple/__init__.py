from .context import ContextWindowModel
from .model import get_model, init_model
from .train import make_fused_epoch, make_fused_eval, make_steps

__all__ = [
    "ContextWindowModel",
    "get_model",
    "init_model",
    "make_fused_epoch",
    "make_fused_eval",
    "make_steps",
]

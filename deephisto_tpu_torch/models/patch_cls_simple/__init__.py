from .model import get_model, init_model

__all__ = ["get_model", "init_model"]

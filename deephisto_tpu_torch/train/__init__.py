"""Training utilities: train state, learning-rate schedules, metrics,
checkpoints in the JAX package's flax msgpack format, and (``dist_ckpt``,
loaded on first use) sharded, async train-state checkpoints on
``torch.distributed.checkpoint``."""

from .checkpoint import (
    BEST_MODEL_FILE,
    load_model,
    load_train_state,
    load_variables,
    model_variables,
    save_model,
    save_train_state,
)
from .metrics import accuracy, cross_entropy_loss
from .state import (
    ReduceLROnPlateau,
    TrainState,
    WarmupCosine,
    create_train_state,
    make_scheduler,
    set_learning_rate,
)

__all__ = [
    "BEST_MODEL_FILE",
    "ReduceLROnPlateau",
    "TrainState",
    "WarmupCosine",
    "accuracy",
    "create_train_state",
    "cross_entropy_loss",
    "dist_ckpt",
    "load_model",
    "load_train_state",
    "load_variables",
    "make_scheduler",
    "model_variables",
    "save_model",
    "save_train_state",
    "set_learning_rate",
]


def __getattr__(name):
    # torch.distributed.checkpoint is imported only by code that checkpoints
    # through it
    if name == "dist_ckpt":
        import importlib

        return importlib.import_module(f"{__name__}.dist_ckpt")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Training utilities: train state, learning-rate schedules, metrics, and
checkpoints in the JAX package's flax msgpack format."""

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
    "load_model",
    "load_train_state",
    "load_variables",
    "make_scheduler",
    "model_variables",
    "save_model",
    "save_train_state",
    "set_learning_rate",
]

"""Training utilities: train state, learning-rate schedules, metrics."""

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
    "ReduceLROnPlateau",
    "TrainState",
    "WarmupCosine",
    "accuracy",
    "create_train_state",
    "cross_entropy_loss",
    "make_scheduler",
    "set_learning_rate",
]

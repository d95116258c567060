"""Training substrate: optimizers, train step, gradient compression."""

from repro_torch.training.optimizer import (
    OptConfig,
    adafactor_update,
    adamw_update,
    init_opt_state,
)
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step

__all__ = [
    "OptConfig",
    "init_opt_state",
    "adamw_update",
    "adafactor_update",
    "TrainState",
    "make_train_step",
    "init_train_state",
]

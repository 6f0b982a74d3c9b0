"""Training substrate of the torch port: optimizers, train step, trainer loop."""

from .optimizer import (  # noqa: F401
    Optimizer,
    adafactor,
    adam8bit,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)
from .train_step import init_state, make_train_step, state_shapes  # noqa: F401
from .trainer import Trainer, TrainerConfig, make_synthetic_trainer  # noqa: F401

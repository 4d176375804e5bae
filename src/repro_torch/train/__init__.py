"""LM training: the train-step factory and the loss (trainer.py, losses.py)."""

from .losses import lm_loss  # noqa: F401
from .trainer import TrainState, init_train_state, make_train_step  # noqa: F401

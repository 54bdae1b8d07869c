"""Training: the optimizer and the training step (monosdf_tpu/train)."""

from .optim import OptimConfig, Optimizer, make_optimizer
from .step import make_train_step

__all__ = ["OptimConfig", "Optimizer", "make_optimizer", "make_train_step"]

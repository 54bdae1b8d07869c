"""Optimizer: Adam with a per-step exponential learning-rate decay
(monosdf_tpu/train/optim.py; reference monosdf_train.py:210-226).

MLP mode is plain Adam with torch's defaults, betas (0.9, 0.999) and eps
1e-8 outside the square root, as optax.adam computes it: update = -lr *
m_hat / (sqrt(v_hat) + eps), m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t).
The learning rate at step t (from 0) is lr * decay_rate^(t / decay_steps).
Grid mode (its three parameter groups) comes with the grid slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 5.0e-4
    sched_decay_rate: float = 0.25
    decay_steps: int = 150_000
    grid_mode: bool = False  # reference Grid_MLP flag


class Optimizer(NamedTuple):
    """The Adam optimizer and its learning-rate schedule; ``schedule.last_epoch``
    counts the steps taken."""

    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR


def make_optimizer(cfg: OptimConfig, params) -> Optimizer:
    """Adam over ``params`` with the exponential decay, stepped once per
    training step."""
    if cfg.grid_mode:
        raise NotImplementedError("grid mode's parameter groups come with the grid slice")
    adam = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    gamma = cfg.sched_decay_rate ** (1.0 / cfg.decay_steps)
    return Optimizer(adam, torch.optim.lr_scheduler.LambdaLR(adam, lambda t: gamma**t))

"""Optimizer: Adam with a per-step exponential learning-rate decay
(monosdf_tpu/train/optim.py; reference monosdf_train.py:210-226).

MLP mode is plain Adam with torch's defaults, betas (0.9, 0.999) and eps
1e-8 outside the square root, as optax.adam computes it: update = -lr *
m_hat / (sqrt(v_hat) + eps), m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t).
Grid mode has three parameter groups, ``encoding`` (the hash table) at lr *
``lr_factor_for_grid``, ``net`` and ``density`` at lr, with betas (0.9,
0.99) and eps 1e-15: the updates of the JAX package's flat_adam with its
per-leaf lr scale. The learning rate at step t (from 0) is lr *
decay_rate^(t / decay_steps) in every group.

``fused`` (the JAX package's one raveled Adam against per-leaf Adam) picks
how torch's Adam runs the same update: True (the default) its multi-tensor
form (``foreach=True``: each step a handful of ``_foreach_*`` launches over
every parameter at once), False its per-parameter loop (``foreach=False``:
the same ops once per parameter). On the CPU both give the same values,
bit for bit (``tests/test_torch_train.py``); ``chip_smoke.py``'s phase 17
compares the two on the card. Neither is torch's single-kernel
``fused=True`` Adam, a library kernel.

``OptimConfig``'s defaults are the JAX dataclass's (factor 20, decay 0.25
over 150,000 steps), which ``bench.py`` and the hard-wired models of
``cli/train.py`` train with; a conf gets the schema's (factor 1.0 and decay
0.1 where the conf is silent, over ``max_total_iters``,
``config.schema.build_configs``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 5.0e-4
    lr_factor_for_grid: float = 20.0  # grid mode: the encoding group's lr factor
    sched_decay_rate: float = 0.25
    decay_steps: int = 150_000
    grid_mode: bool = False  # reference Grid_MLP flag
    fused: bool = True  # multi-tensor Adam (foreach); False: one parameter at a time


class Optimizer(NamedTuple):
    """The Adam optimizer and its learning-rate schedule; ``schedule.last_epoch``
    counts the steps taken."""

    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR


def grid_group(name: str) -> str:
    """The grid-mode group of a parameter name: 'encoding', 'density' or 'net'."""
    parts = name.split(".")
    if "encoding" in parts:
        return "encoding"
    return "density" if parts[0] == "density" else "net"


def make_optimizer(cfg: OptimConfig, named_params) -> Optimizer:
    """Adam over ``named_params``, (name, tensor) pairs as
    ``named_parameters()`` gives them, with the exponential decay, stepped
    once per training step."""
    named_params = list(named_params)
    lr = cfg.learning_rate
    if cfg.grid_mode:
        factor = {"encoding": cfg.lr_factor_for_grid, "net": 1.0, "density": 1.0}
        groups = {g: [] for g in factor}
        for name, p in named_params:
            groups[grid_group(name)].append(p)
        adam = torch.optim.Adam([{"params": ps, "lr": lr * factor[g]}
                                 for g, ps in groups.items() if ps],
                                lr=lr, betas=(0.9, 0.99), eps=1e-15, foreach=cfg.fused)
    else:
        adam = torch.optim.Adam([p for _, p in named_params], lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, foreach=cfg.fused)
    gamma = cfg.sched_decay_rate ** (1.0 / cfg.decay_steps)
    return Optimizer(adam, torch.optim.lr_scheduler.LambdaLR(adam, lambda t: gamma**t))

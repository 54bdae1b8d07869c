"""Data parallelism (monosdf_tpu/parallel): DDP over ``torch.distributed``."""

from .ddp import (
    init_group,
    make_parallel_train_step,
    rank_generator,
    replicate,
    shard_batch,
    spawn,
    world,
)
from .dryrun import dryrun_ddp

__all__ = ["dryrun_ddp", "init_group", "make_parallel_train_step", "rank_generator",
           "replicate", "shard_batch", "spawn", "world"]

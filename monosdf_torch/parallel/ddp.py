"""Data parallelism over ``torch.distributed`` (monosdf_tpu/parallel/mesh.py).

The JAX package shards the ray batch over a ``('data',)`` mesh and
``pmean``s the gradients; the port runs one process per card under
``DistributedDataParallel``, the reference's own scheme
(code/training/exp_runner.py:74-77, monosdf_train.py:228-229):

* ``init_group`` joins the process group (``make_mesh``'s place): NCCL for a
  CUDA device, gloo for the CPU, or the backend the caller names; the
  rendezvous is a ``FileStore`` in a directory the caller gives, or
  ``env://`` under ``torchrun``;
* ``replicate`` wraps the model in DDP: rank 0's parameters are broadcast
  once, and each backward's gradients are all-reduced (averaged) in buckets
  while the backward runs, as XLA overlaps ``pmean``;
* ``shard_batch`` keeps a rank's contiguous rows of a global batch, the rows
  the JAX package's ``shard_batch`` places on device ``rank``;
* ``make_parallel_train_step``'s step renders and takes the loss of the
  rank's own rays (so each rank solves its own depth scale and shift), with
  its own random draws (``rank_generator``), and every rank applies the same
  Adam update; its metrics are the mean over ranks (``pmean``), ``beta``
  read after the update.

``spawn`` starts one worker process per rank and joins them within a
deadline: ``cli/train.py --n_devices N``, ``parallel.dryrun`` and the tests
use it.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..losses import LossConfig
from ..models.monosdf import MonoSDF, MonoSDFConfig
from ..train.optim import Optimizer
from ..train.step import step_losses, updated_beta

# how long a collective may wait for the other ranks (a rank-0-only mesh
# export or plot runs while the others wait at the next all-reduce)
GROUP_TIMEOUT_S = 1800.0


def init_group(rank: int | None = None, world_size: int | None = None,
               store_dir: str | None = None, device=None,
               backend: str | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    ``device``: the rank's device (``cuda`` unless ``'cpu'``; ``cuda`` with
    no index takes the rank's ``LOCAL_RANK``, else its rank). ``backend``:
    ``'nccl'`` for a CUDA device and ``'gloo'`` for the CPU unless named
    (gloo also reduces CUDA tensors). ``store_dir``: a directory for the
    ``FileStore`` rendezvous (the same for every rank, fresh for each
    group); None: ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, as ``torchrun`` sets them; ``rank`` and ``world_size``
    default to theirs). A failed init raises."""
    if store_dir is None:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        init_method = "env://"
    else:
        os.makedirs(store_dir, exist_ok=True)
        init_method = "file://" + os.path.join(os.path.abspath(store_dir), "rendezvous")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dev


def in_group() -> bool:
    """Whether this process has joined a default process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> tuple:
    """(rank, world size) of the default group; (0, 1) without one."""
    if in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Replica(nn.Module):
    """The module DDP wraps: ``forward(fn, *args, **kwargs)`` returns
    ``fn(model, *args, **kwargs)``, so that a render and its loss run inside
    DDP's forward, which arms the gradient all-reduce of the backward that
    follows (a call on the bare model would skip it)."""

    def __init__(self, model: MonoSDF):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def replicate(model: MonoSDF):
    """``model`` under ``DistributedDataParallel`` on its device (JAX's
    ``replicate``): rank 0's parameters are broadcast to every rank. The
    parameters stay ``model``'s own, so an optimizer and a checkpoint made
    from ``model`` serve the wrapped one. Every parameter must get a
    gradient in each step (no ``find_unused_parameters``): a zero gradient
    counts, as optax's update decays the moments of a zero gradient where
    ``torch.optim.Adam`` skips a missing one."""
    dev = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        Replica(model), device_ids=[dev.index] if dev.type == "cuda" else None)


def shard_batch(batch, rank: int, world_size: int):
    """Rows ``rank*per:(rank+1)*per`` of every leaf (numpy array or tensor)
    of a global batch whose leading axis is ``per * world_size`` long: the
    contiguous shards of the JAX package's ``shard_batch``."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world_size) for k, v in batch.items()}
    n = batch.shape[0]
    if n % world_size:
        raise ValueError(f"a global batch of {n} rows does not split over {world_size} ranks")
    per = n // world_size
    return batch[rank * per:(rank + 1) * per]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s draws: ``seed`` itself on rank 0 (the
    single-device run's stream), one of its own on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The ``torch.Generator`` of rank ``rank``'s sampler and eikonal draws
    (JAX: ``fold_in(key, axis_index)``)."""
    return torch.Generator(device=device).manual_seed(rank_seed(seed, rank))


def mean_over_ranks(metrics: dict) -> dict:
    """Each 0-d metric averaged over the ranks (JAX's ``pmean``): one
    all-reduce of the stacked values, which every rank must join."""
    keys = list(metrics)
    vec = torch.stack([metrics[k].float() for k in keys])
    _, n = world()
    if in_group():
        dist.all_reduce(vec)
        vec = vec / n
    return dict(zip(keys, vec.unbind()))


def make_parallel_train_step(cfg: MonoSDFConfig, loss_cfg: LossConfig, optimizer: Optimizer):
    """Returns ``step(ddp_model, local_batch, draws=None, generator=None,
    reduce_metrics=True) -> metrics``, the data-parallel
    ``train.step.make_train_step``: ``ddp_model`` from ``replicate``,
    ``local_batch`` this rank's rays (``shard_batch``), ``draws``/
    ``generator`` this rank's random draws (``rank_generator``). It renders,
    takes the loss at the schedule's step, back-propagates with the gradients
    averaged over the ranks, and steps Adam and the schedule, the same update
    on every rank. metrics: the loss terms and ``psnr`` averaged over the
    ranks (with ``reduce_metrics``; else this rank's own: a step whose
    metrics are not read need not wait for the others), and the updated
    ``beta``, as 0-d tensors."""
    adam, schedule = optimizer

    def step(ddp_model, local_batch: dict, draws=None, generator=None,
             reduce_metrics: bool = True) -> dict:
        adam.zero_grad(set_to_none=True)
        losses = ddp_model(step_losses, cfg, loss_cfg, local_batch, schedule.last_epoch, draws,
                           generator)
        losses["loss"].backward()
        adam.step()
        schedule.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        if reduce_metrics:
            metrics = mean_over_ranks(metrics)
        metrics["beta"] = updated_beta(ddp_model.module.model, cfg)
        return metrics

    return step


def replicas_agree(model: nn.Module) -> bool:
    """Whether every rank holds the same parameters, bit for bit: each
    rank's digest of its parameters' bytes, gathered (True without a group)."""
    import hashlib

    if world()[1] == 1:
        return True
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    digests = [None] * world()[1]
    dist.all_gather_object(digests, h.hexdigest())
    return len(set(digests)) == 1


def barrier():
    """Wait for every rank of the default group (nothing without one)."""
    if world()[1] > 1:
        dist.barrier()


def broadcast_object(obj):
    """``obj`` as rank 0 has it, on every rank (itself without a group)."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _worker(rank: int, fn, world_size: int, store_dir: str, args: tuple):
    """A spawned rank: ``fn(rank, world_size, store_dir, *args)``; a failure
    leaves its traceback in ``store_dir/error_<rank>.txt`` and exits non-zero."""
    try:
        fn(rank, world_size, store_dir, *args)
    except BaseException:
        with open(os.path.join(store_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if in_group():
            dist.destroy_process_group()


class Workers:
    """Spawned rank processes (``spawn(..., join=False)``)."""

    def __init__(self, procs: list, store_dir: str):
        self.procs, self.store_dir = procs, store_dir

    def join(self, timeout_s: float | None = None):
        """Wait for every rank to exit 0 (within ``timeout_s`` seconds where
        given). A rank that fails, or a deadline that passes, kills every
        rank and raises."""
        deadline = math.inf if timeout_s is None else time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.exitcode for p in self.procs]
                bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    time.sleep(0.5)  # let a failing rank finish its traceback
                    errors = []
                    for r, c in bad:
                        path = os.path.join(self.store_dir, f"error_{r}.txt")
                        text = open(path).read() if os.path.exists(path) else ""
                        errors.append(f"rank {r} exited with {c}:\n{text}")
                    raise RuntimeError("\n".join(errors))
                if all(c == 0 for c in codes):
                    return
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within {timeout_s:.0f} s "
                                       f"(exit codes {codes})")
                time.sleep(0.05)
        finally:
            self.kill()

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)


def spawn(fn, world_size: int, args: tuple = (), store_dir: str | None = None,
          join: bool = True, timeout_s: float | None = None):
    """Run ``fn(rank, world_size, store_dir, *args)`` in ``world_size``
    processes (``torch.multiprocessing``, start method ``spawn``; ``fn`` and
    ``args`` must pickle). ``store_dir`` is every rank's, for
    ``init_group``'s rendezvous and the ranks' error files (None: a
    temporary directory, removed after the join). With ``join`` waits
    (within ``timeout_s`` seconds where given, ``Workers.join``); else
    returns the ``Workers``."""
    import torch.multiprocessing as mp

    if store_dir is None:
        if not join:
            raise ValueError("spawn(join=False) needs a store_dir that outlives the call")
        with tempfile.TemporaryDirectory(prefix="ddp-") as tmp:
            return spawn(fn, world_size, args, tmp, True, timeout_s)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, fn, world_size, store_dir, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    workers = Workers(procs, store_dir)
    if join:
        workers.join(timeout_s)
    return workers

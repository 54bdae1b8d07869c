"""One data-parallel training step of the flagship program
(``__graft_entry__.py`` ``_flagship_cfg`` and ``dryrun_multichip``).

``flagship_config`` copies the JAX package's flagship configuration field
for field onto the port's configs: the ScanNet grids model (16 levels x 2
channels of 2^19 hashed rows, a bf16 table, the quad layout with the Pallas
build and fold, sweeps over the first 8 levels), 256-wide MLPs, per-image
codes and the 5-iteration error-bounded sampler; ``tiny`` the small smoke
model. The build and fold in Pallas route the model onto the port's kernel
grid path (``config.schema``'s routing rule): K1 and K6 in the sweeps, K6,
K7f, K7b and K5 in the step.

``dryrun_ddp(N)`` runs one DDP step of it over N ranks, rays sharded and
parameters replicated, each rank with its own rays, ``indices`` and draws,
and prints ``dryrun_ddp(N): OK loss=...``. Inside a process group of N
ranks each rank runs its part; else, on the CPU, it spawns N gloo workers
(as JAX provisions N virtual CPU devices), and on the card one rank per
card (NCCL), in this process at N = 1.

    python -m monosdf_torch.parallel.dryrun [--n 1] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from ..losses import LossConfig
from ..models.fields import ImplicitNetConfig, RenderingNetConfig
from ..models.monosdf import MonoSDFConfig, init_monosdf
from ..ops.hashgrid import HashGridConfig
from ..ops.sampler import SamplerConfig
from ..train.optim import OptimConfig, make_optimizer
from .ddp import (init_group, make_parallel_train_step, rank_generator, replicate, shard_batch,
                  spawn, world)


def flagship_config(tiny: bool = False) -> MonoSDFConfig:
    """The flagship model (``__graft_entry__.py:18-73``), routed as
    ``config.build_configs`` routes a grid conf with the Pallas build and
    fold: sampler and differentiated forward on the kernel grid path."""
    if tiny:
        grid = HashGridConfig(num_levels=4, log2_hashmap_size=8, desired_resolution=32)
        implicit = ImplicitNetConfig(feature_vector_size=16, dims=(32, 32), multires=6,
                                     inside_outside=True, use_grid=True, grid=grid,
                                     sdf_bounding_sphere=0.0)
        rendering = RenderingNetConfig(feature_vector_size=16, dims=(32, 32), multires_view=4,
                                       per_image_code=False)
        sampler = SamplerConfig(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                                max_total_iters=2, intersection="cube")
    else:
        grid = HashGridConfig(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=19, desired_resolution=2048,
                              table_dtype="bfloat16", scatter_impl="fold", hash_scheme="add",
                              layout="quad", fold_impl="pallas", build_impl="pallas",
                              param_flat=True, sweep_oct_levels=8)
        implicit = ImplicitNetConfig(feature_vector_size=256, dims=(256, 256), multires=6,
                                     inside_outside=True, bias=0.9, use_grid=True, grid=grid,
                                     divide_factor=1.1, sdf_bounding_sphere=0.0)
        rendering = RenderingNetConfig(feature_vector_size=256, dims=(256, 256),
                                       multires_view=4, per_image_code=True)
        sampler = SamplerConfig(scene_bounding_sphere=1.1, N_samples=64, N_samples_eval=128,
                                N_samples_extra=32, max_total_iters=5, intersection="cube")
    routed = "pallas" in (grid.build_impl, grid.fold_impl)
    return MonoSDFConfig(
        implicit=implicit, rendering=rendering, sampler=sampler,
        sweep_max_level=None if tiny else 8,
        sampler_backend="pallas" if routed else "jnp",
        diff_backend="pallas" if routed else "jnp",
    )


def _dryrun_rank(rank: int, world_size: int, tiny: bool, device, rays_per_rank: int) -> float:
    """This rank's part of the step, inside the group; the loss (mean over ranks)."""
    from ..data.synthetic import make_synthetic_sphere_scene, sample_ray_batch

    cfg = flagship_config(tiny)
    model = init_monosdf(cfg, seed=0, device=device)
    opt = make_optimizer(OptimConfig(grid_mode=True, lr_factor_for_grid=20.0, decay_steps=1000),
                         model.named_parameters())
    ddp_model = replicate(model)
    scene = make_synthetic_sphere_scene(n_images=2, img_res=32)
    batch = sample_ray_batch(scene, np.random.default_rng(0), rays_per_rank * world_size)
    if not cfg.rendering.per_image_code:
        batch.pop("indices")  # the tiny model has no appearance codes
    else:
        batch["indices"] = batch["indices"].astype(np.int64)
    local = shard_batch(batch, rank, world_size)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    local = {k: ({kk: to_dev(vv) for kk, vv in v.items()} if isinstance(v, dict) else to_dev(v))
             for k, v in local.items()}
    step = make_parallel_train_step(cfg, LossConfig(), opt)
    metrics = step(ddp_model, local, generator=rank_generator(0, rank, device))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"dryrun_ddp({world_size}): non-finite loss {loss}")
    return loss


def _spawned(rank: int, world_size: int, store_dir: str, tiny: bool, device: str,
             rays_per_rank: int):
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    init_group(rank, world_size, store_dir, dev)
    loss = _dryrun_rank(rank, world_size, tiny, dev, rays_per_rank)
    if rank == 0:
        with open(os.path.join(store_dir, "loss.txt"), "w") as f:
            f.write(repr(loss))


def dryrun_ddp(world_size: int, tiny: bool = False, device=None,
               rays_per_rank: int | None = None) -> float:
    """One DDP training step of the flagship program over ``world_size``
    ranks (``rays_per_rank`` rays each: JAX's 16, tiny 8); prints and
    returns its loss, the mean over ranks, and raises on a non-finite one."""
    dev = resolve_device(device)
    rays_per_rank = rays_per_rank or (8 if tiny else 16)
    rank, n = world()
    if torch.distributed.is_initialized():
        if n != world_size:
            raise ValueError(f"dryrun_ddp({world_size}) inside a group of {n} ranks")
        loss = _dryrun_rank(rank, world_size, tiny, dev, rays_per_rank)
    elif world_size == 1:
        with tempfile.TemporaryDirectory(prefix="dryrun-") as store:
            init_group(0, 1, store, dev)
            try:
                loss = _dryrun_rank(0, 1, tiny, dev, rays_per_rank)
            finally:
                torch.distributed.destroy_process_group()
    else:
        if dev.type == "cuda" and world_size > torch.cuda.device_count():
            raise ValueError(f"dryrun_ddp({world_size}) needs {world_size} cards, "
                             f"{torch.cuda.device_count()} present")
        with tempfile.TemporaryDirectory(prefix="dryrun-") as store:
            spawn(_spawned, world_size, (tiny, dev.type, rays_per_rank), store_dir=store)
            with open(os.path.join(store, "loss.txt")) as f:
                loss = float(f.read())
    if rank == 0:
        print(f"dryrun_ddp({world_size}): OK loss={loss:.4f}", flush=True)
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser(description="one DDP step of the flagship program")
    ap.add_argument("--n", type=int, default=1, help="ranks (cards; gloo workers on the CPU)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dryrun_ddp(args.n, args.tiny, args.device)


if __name__ == "__main__":
    main()

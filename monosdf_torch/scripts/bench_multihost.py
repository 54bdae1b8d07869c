"""Rays/s of the flagship data-parallel training step at 1..N ranks (the
port of scripts/bench_multihost.py): the program ``parallel.dryrun``
checks (``flagship_config``, ``flagship_program``: the grids model with
codes, rays sharded, parameters replicated under DDP), timed.

    python -m monosdf_torch.scripts.bench_multihost [--rays_per_device 1024]   # every local card
    python -m monosdf_torch.scripts.bench_multihost --n_devices 1               # one card
    python -m monosdf_torch.scripts.bench_multihost --virtual 2 --tiny          # 2 gloo ranks on the CPU
    torchrun --nnodes H --nproc_per_node G ... -m monosdf_torch.scripts.bench_multihost --multihost

One rank per card (NCCL), or per gloo worker on the CPU; at one rank the
step runs in this process, else the ranks are spawned
(``parallel.ddp.spawn``), or started by torchrun under ``--multihost``.
Each rank takes ``--rays_per_device`` rays of a global batch drawn from
the synthetic sphere (2 views of 64x64) and sharded; Adam as the JAX
script's (grid mode, factor 20, 150,000 decay steps). ``--warmup`` steps
(at least 1), then ``--iters`` timed steps from the host clock to the
loss's read. Rank 0 prints ONE JSON line: ``n_processes``, ``n_devices``,
``ms_per_step``, ``rays_per_sec``, ``rays_per_sec_per_device`` and
``backend`` (the JAX script's keys; ``backend`` is the device type, cuda or
cpu), with ``collective`` (nccl or gloo), ``loss`` (the last step's, the
mean over ranks), ``launches_per_step`` (rank 0's kernels over the timed
steps) and ``device``.

Flags of scripts/bench_multihost.py: ``--n_devices`` (0: every local card;
1 on the CPU), ``--rays_per_device``, ``--iters``, ``--warmup``,
``--tiny`` and ``--multihost`` (``jax.distributed.initialize()``'s place:
join torchrun's group, ``env://``) have their counterparts; ``--virtual
N`` (N virtual CPU devices) becomes N gloo ranks on the CPU. The port adds
``--device``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import torch

from ..device import resolve_device
from ..kernels import build
from ..parallel.ddp import in_group, init_group, spawn, world
from ..parallel.dryrun import flagship_program

SPAWN_DEADLINE_S = 1800.0


def _measure(rank: int, world_size: int, device, args) -> dict:
    """This rank's timed steps inside the group; the line (rank 0's)."""
    step, ddp_model, local, gen = flagship_program(rank, world_size, args.tiny, device,
                                                   args.rays_per_device, decay_steps=150_000,
                                                   img_res=64)
    for _ in range(max(1, args.warmup)):
        metrics = step(ddp_model, local, generator=gen)
    float(metrics["loss"])
    before = dict(build.launches)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        metrics = step(ddp_model, local, generator=gen)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / args.iters
    if not math.isfinite(loss):
        raise FloatingPointError(f"bench_multihost: non-finite loss {loss}")
    total = args.rays_per_device * world_size
    return {
        "n_processes": world_size,
        "n_devices": world_size,
        "ms_per_step": dt * 1e3,
        "rays_per_sec": total / dt,
        "rays_per_sec_per_device": total / dt / world_size,
        "backend": device.type,
        "collective": torch.distributed.get_backend(),
        "loss": loss,
        "launches_per_step": {k: (v - before[k]) / args.iters for k, v in build.launches.items()
                              if v != before[k]},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def _spawned(rank: int, world_size: int, store_dir: str, device_type: str, args):
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    init_group(rank, world_size, store_dir, dev)
    if dev.type == "cuda":
        build.build_all()
    line = _measure(rank, world_size, dev, args)
    if rank == 0:
        with open(os.path.join(store_dir, "line.json"), "w") as f:
            json.dump(line, f)


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_devices", type=int, default=0,
                    help="ranks, one a card (0: every local card; 1 on the CPU)")
    ap.add_argument("--virtual", type=int, default=0, help="N gloo ranks on the CPU")
    ap.add_argument("--rays_per_device", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--multihost", action="store_true", help="join torchrun's process group")
    ap.add_argument("--tiny", action="store_true", help="the small smoke model")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    if args.multihost:
        dev = init_group(device=args.device)
        if dev.type == "cuda":
            build.build_all()
        rank, n = world()
        try:
            line = _measure(rank, n, dev, args)
        finally:
            torch.distributed.destroy_process_group()
        if rank == 0:
            print(json.dumps(line), flush=True)
        return line if rank == 0 else None

    dev = resolve_device("cpu" if args.virtual else args.device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = args.virtual or args.n_devices or local
    if dev.type == "cuda" and n > local:
        raise ValueError(f"--n_devices {n}: {local} cards present")
    with tempfile.TemporaryDirectory(prefix="bench-multihost-") as store:
        if n == 1 and not in_group():
            dev = init_group(0, 1, store, dev)
            if dev.type == "cuda":
                build.build_all()
            try:
                line = _measure(0, 1, dev, args)
            finally:
                torch.distributed.destroy_process_group()
        else:
            spawn(_spawned, n, (dev.type, args), store_dir=store, timeout_s=SPAWN_DEADLINE_S)
            with open(os.path.join(store, "line.json")) as f:
                line = json.load(f)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

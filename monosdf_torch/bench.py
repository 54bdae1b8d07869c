"""The port's bench: ``bench.py``'s work on the card, in rays per second.

    python -m monosdf_torch.bench            # the ScanNet-MLP model
    python -m monosdf_torch.bench --grids    # its hash-grid model

The training step of ``cli/train.py`` (``make_trainer``) at full width in
bf16 on the synthetic sphere scene (4 views of 64x64): 1024 rays a step,
Adam with ``OptimConfig(learning_rate=5e-4, decay_steps=150_000,
grid_mode=grids)``, as ``bench.py`` (its :121; ``make_trainer``'s
``OptimConfig(grid_mode=grids)``, checked equal), 3 warm-up steps on the
first batch, then 20 timed steps, each on its own ray batch
(``cli/train.py ray_batches``, made on the device before the timing
window, as ``bench.py``:128-140 does), from the host clock to a
synchronise. Prints ONE JSON line ``{metric, value, unit, vs_baseline}``;
``vs_baseline`` is the rate over this package's copies of bench.py's
reference-class estimates (``REFERENCE_RAYS_PER_SEC``,
``REFERENCE_GRIDS_RAYS_PER_SEC``, derived in BASELINE.md), never over a TPU
figure. The metric names the device. Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .cli.eval import bench_config
from .cli.train import make_trainer, ray_batches
from .data.synthetic import make_synthetic_sphere_scene
from .device import resolve_device
from .models.monosdf import init_monosdf
from .train import OptimConfig

# bench.py:28-32: reference-class single-A100 estimates of the reference
# implementation (BASELINE.md), not measurements of this package
REFERENCE_RAYS_PER_SEC = 10_700.0
REFERENCE_GRIDS_RAYS_PER_SEC = 15_000.0
NUM_RAYS = 1024
WARMUP = 3
ITERS = 20


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", action="store_true", help="the hash-grid model of bench.py --grids")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = bench_config(args.grids, "bfloat16")
    model = init_monosdf(cfg, seed=0, device=device)
    bench_optim = OptimConfig(learning_rate=5e-4, decay_steps=150_000, grid_mode=args.grids)
    if OptimConfig(grid_mode=cfg.implicit.use_grid) != bench_optim:
        raise RuntimeError("cli/train.py make_trainer's optimizer is not bench.py's")
    step = make_trainer(model, cfg)
    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    batches = ray_batches(scene, np.random.default_rng(0), ITERS, NUM_RAYS, device)
    generator = torch.Generator(device=device).manual_seed(0)

    for _ in range(WARMUP):
        step(model, batches[0], generator=generator)
    _sync(device)
    t0 = time.perf_counter()
    for b in batches:
        metrics = step(model, b, generator=generator)
    _sync(device)
    dt = time.perf_counter() - t0
    if not np.isfinite(float(metrics["loss"])):
        raise RuntimeError("the last timed step's loss is not finite")

    rays_per_sec = NUM_RAYS * ITERS / dt
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    what = "grids" if args.grids else "MLP"
    line = {
        "metric": f"rays/s/chip (fwd+bwd+opt), ScanNet {what} config, monosdf_torch on {name}",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / (REFERENCE_GRIDS_RAYS_PER_SEC if args.grids
                                             else REFERENCE_RAYS_PER_SEC), 3),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

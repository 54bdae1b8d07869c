"""Train the bench's ScanNet-MLP model on the synthetic sphere scene: the
work ``bench.py`` times (``monosdf_tpu/train/step.py make_train_step`` on
1024-ray batches: render, MonoSDF loss, backward, Adam). ``--grids`` trains
the hash-grid model of ``bench.py --grids`` instead, with the grid-mode Adam
(three parameter groups, the table's at 20x the learning rate); ``--union``
the appearance-code model of ``confs/synth_union_quality.conf``, each ray
with its frame's per-image code (a row of ``rendering.embeddings``, trained
with the rest); ``--rgb_backend pallas`` takes the radiance through K8a
instead of K3; ``--sweep_pe`` the sampler sweeps of an MLP model through
K1-PE (the positional encoding inside the kernel, ``sweep_pe_in_kernel``).

The model is ``cli/eval.py bench_mlp_config``, ``bench_grids_config`` or
``union_codes_config`` (bf16 operands with float32 sums, or
``--compute_dtype float32``), from the port's initialisation
(``--init_seed``) or an ``.npz`` of a JAX parameter tree (``--params``),
trained with ``LossConfig()`` and ``OptimConfig()`` (Adam, lr 5e-4, decay
over 150,000 steps), as ``bench.py``. Each step draws a fresh ray batch
from the scene (numpy) and the sampler's and eikonal draws from a
``torch.Generator`` on the device, both seeded with 0; it prints loss,
psnr and beta. The trained parameters are written to
``--out`` as an ``.npz`` that ``cli/eval.py --params`` reads. Runs on the
card unless ``--device cpu``. No checkpoints, config files or validation
renders: the trainer's other features come with a later slice.

    python -m monosdf_torch.cli.train --steps 20 --out trained.npz
    python -m monosdf_torch.cli.train --grids --steps 20 --out trained_grids.npz
    python -m monosdf_torch.cli.train --union --steps 20 --out trained_union.npz
    python -m monosdf_torch.cli.train --sweep_pe --steps 20 --out trained_pe.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.synthetic import make_synthetic_sphere_scene, sample_ray_batch
from ..device import resolve_device
from ..losses import LossConfig
from ..models.monosdf import init_monosdf
from ..params import load_jax_params, load_params_npz, params_to_tree, save_params_npz
from ..train import OptimConfig, make_optimizer, make_train_step
from .eval import add_model_args, bench_config, model_config


def ray_batches(scene: dict, rng: np.random.Generator, n: int, num_rays: int, device) -> list:
    """n distinct ray batches of ``num_rays`` random pixels, on ``device``:
    rays, ground truth and each ray's frame (``indices``, int64)."""
    out = []
    for _ in range(n):
        b = sample_ray_batch(scene, rng, num_rays)
        batch = {k: {kk: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for kk, v in b[k].items()} for k in ("rays", "gt")}
        batch["indices"] = torch.from_numpy(b["indices"].astype(np.int64)).to(device)
        out.append(batch)
    return out


def make_trainer(model, cfg):
    """The bench's training step of ``model``: ``LossConfig()`` and Adam
    (``OptimConfig()``, in grid mode with its parameter groups) over its
    parameters."""
    ocfg = OptimConfig(grid_mode=cfg.implicit.use_grid)
    return make_train_step(cfg, LossConfig(), make_optimizer(ocfg, model.named_parameters()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(ap)
    ap.add_argument("--params", default=None, help=".npz of a JAX parameter tree")
    ap.add_argument("--init_seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rays", type=int, default=1024, help="rays per step")
    ap.add_argument("--n_images", type=int, default=4)
    ap.add_argument("--img_res", type=int, default=64)
    ap.add_argument("--compute_dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out", default="trained_params.npz")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args, args.compute_dtype)
    model = init_monosdf(cfg, seed=args.init_seed, device=device)
    if args.params:
        load_jax_params(model, load_params_npz(args.params))
    step = make_trainer(model, cfg)
    scene = make_synthetic_sphere_scene(n_images=args.n_images, img_res=args.img_res)
    rng = np.random.default_rng(0)
    generator = torch.Generator(device=device).manual_seed(0)
    history = []
    for i in range(args.steps):
        (batch,) = ray_batches(scene, rng, 1, args.rays, device)
        m = {k: float(v) for k, v in step(model, batch, generator=generator).items()}
        history.append(m)
        print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} beta {m['beta']:.5f}",
              flush=True)
    save_params_npz(args.out, params_to_tree(model))
    return history


if __name__ == "__main__":
    main()

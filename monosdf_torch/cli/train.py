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
``--out`` as an ``.npz`` that ``cli/eval.py --params`` reads. The scene is
the synthetic sphere, or with ``--data_dir`` a scene directory under
``--data_root`` (``data.SceneDataset``: ``pixel_rays`` of its split,
``--img_res H W``, ``--center_crop_type``; ``--if_hdr``: EXR frames, the
model's HDR output and the rgb loss through the sRGB gamma, as
``confs/synth_union_hdr.conf``). Runs on the card unless ``--device cpu``.
These hard-wired runs write no checkpoint.

With ``--conf`` (and an overlay ``--conf_add``) it is the counterpart of
monosdf_tpu/cli/train.py, the exp_runner.py equivalent: the HOCON conf
builds the model, loss and optimizer (``config.build_configs``: the conf's
backends, the kernel routing rule, its learning-rate factor and decay), the
scene is ``<data_root>/<dataset.data_dir>`` (``--scan_id``), and
``train.trainer.Trainer`` trains it with checkpoints (resume with
``--resume``, warm start with ``--load_from``), metrics, validation plots
and a mesh at the end, under ``<exps_root>/<timestamp>-<prefix><expname>
<suffix>``. ``--profile_dir`` writes a ``torch.profiler`` trace of the first
50 steps there (``trace.json``).

Data parallelism (``--conf`` runs; ``parallel``, DDP): ``--n_devices N``
trains on N cards of this machine, one spawned worker a card, each rank on
its contiguous share of a global batch of N x ``num_pixels`` rays (0, the
default, takes every local card; 1 on the CPU; more cards than exist
raise, and no card takes two ranks); ``--device cpu --n_devices N`` runs N
gloo workers on the CPU. ``--multihost`` joins the group that ``torchrun``
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), one process a card, as ``jax.distributed.initialize()``
does for the JAX CLI. Rank 0 writes the run directory's files.

    python -m monosdf_torch.cli.train --conf confs/synth_union_quality.conf \
        --data_root scenes --exps_root exps [--conf_add overlay.conf] [--resume] [--max_iters N]
    python -m monosdf_torch.cli.train --conf confs/synth_union_quality.conf \
        --data_root scenes --n_devices 2            # two cards, DDP over NCCL
    torchrun --nnodes 2 --nproc_per_node 8 --rdzv_backend c10d --rdzv_endpoint HOST:29500 \
        -m monosdf_torch.cli.train --conf confs/scannet_mlp.conf --multihost   # across machines
    python -m monosdf_torch.cli.train --steps 20 --out trained.npz
    python -m monosdf_torch.cli.train --grids --steps 20 --out trained_grids.npz
    python -m monosdf_torch.cli.train --union --steps 20 --out trained_union.npz
    python -m monosdf_torch.cli.train --sweep_pe --steps 20 --out trained_pe.npz
    python -m monosdf_torch.scripts.make_synthetic_scene scenes --shape union --n 4 --res 64
    python -m monosdf_torch.cli.train --union --data_root scenes --data_dir union_scene \
        --img_res 64 64 --steps 20 --out trained_union.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.scene_dataset import SceneDataset
from ..data.synthetic import make_synthetic_sphere_scene, sample_ray_batch
from ..device import resolve_device
from ..losses import LossConfig
from ..models.monosdf import init_monosdf
from ..parallel.ddp import init_group, spawn, world
from ..params import load_jax_params, load_params_npz, params_to_tree, save_params_npz
from ..train import OptimConfig, make_optimizer, make_train_step
from .eval import (add_data_args, add_model_args, bench_config, dataset_config, model_config,
                   sphere_res)


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
    """The bench's training step of ``model``: ``LossConfig()`` (with the HDR
    output, ``rendering.if_hdr``, the rgb loss through the sRGB gamma) and
    Adam (``OptimConfig()``, in grid mode with its parameter groups) over
    its parameters."""
    ocfg = OptimConfig(grid_mode=cfg.implicit.use_grid)
    return make_train_step(cfg, LossConfig(if_gamma_loss=cfg.rendering.if_hdr),
                           make_optimizer(ocfg, model.named_parameters()))


def load_scene(args) -> dict:
    """The flat per-ray arrays the steps draw from: ``pixel_rays()`` of the
    scene directory ``--data_dir`` names, else the synthetic sphere."""
    if args.data_dir:
        return SceneDataset(dataset_config(args)).pixel_rays()
    return make_synthetic_sphere_scene(n_images=args.n_images, img_res=sphere_res(args))


def add_conf_args(ap):
    """The flags of a ``--conf`` run (monosdf_tpu/cli/train.py's)."""
    ap.add_argument("--conf", default=None, help="a HOCON conf: train it with the Trainer")
    ap.add_argument("--conf_add", default=None, help="an overlay conf merged over --conf")
    ap.add_argument("--scan_id", default="")
    ap.add_argument("--exps_root", default="exps",
                    help="where the run directories go (default: exps/ under the working "
                         "directory; the JAX CLI's default is ../exps)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--load_from", default=None,
                    help="warm-start from another run's latest checkpoint, matched by run-dir "
                         "prefix (exp_runner.py:29)")
    ap.add_argument("--prefix", default="", help="expname prefix (exp_runner.py:27)")
    ap.add_argument("--append", default="", help="expname suffix (exp_runner.py:26)")
    ap.add_argument("--timestamp", default=None)
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--n_devices", type=int, default=0,
                    help="ranks of a data-parallel run: 0 = all local cards (1 on the CPU); "
                         "with --device cpu, N gloo workers")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes (env://)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of the first 50 steps")


def local_devices(device) -> int:
    """The ranks ``--n_devices 0`` means: every card of this machine, 1 on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _conf_rank(rank: int, world_size: int, store_dir: str, args):
    """A spawned rank of ``--n_devices N``: card ``rank`` (or the CPU) in the group."""
    dev = torch.device("cpu") if resolve_device(args.device).type == "cpu" else \
        torch.device("cuda", rank)
    conf_run(args, init_group(rank, world_size, store_dir, dev))


def conf_main(args):
    """Train the model of ``--conf`` (monosdf_tpu/cli/train.py main): in
    this process, or with ``--n_devices N`` > 1 in N spawned ranks, or with
    ``--multihost`` as a rank of torchrun's group. Returns the Trainer (None
    from the spawning process)."""
    if args.multihost:
        return conf_run(args, init_group(device=args.device))
    n = args.n_devices or local_devices(args.device)
    if n > 1:
        if resolve_device(args.device).type == "cuda" and n > torch.cuda.device_count():
            raise ValueError(f"--n_devices {n}: {torch.cuda.device_count()} cards present")
        spawn(_conf_rank, n, (args,))
        return None
    return conf_run(args, resolve_device(args.device))


def conf_run(args, device):
    """Train the model of ``--conf`` on ``device``, inside the default
    process group where there is one (a DDP rank)."""
    from ..config import build_configs, load_conf
    from ..train.trainer import Trainer
    from .common import dataset_config_from_conf

    rank, n_ranks = world()
    exp = build_configs(load_conf(args.conf, args.conf_add))
    train_ds = SceneDataset(dataset_config_from_conf(exp.dataset, args.data_root, args.scan_id,
                                                     "train"))
    try:
        val_ds = SceneDataset(dataset_config_from_conf(exp.dataset, args.data_root, args.scan_id,
                                                       "val"))
        val_images = [val_ds.image_rays(i) for i in range(min(2, len(val_ds.frame_idx_list)))]
    except Exception as e:  # val split optional
        print(f"no val split: {e}")
        val_images = []
    trainer = Trainer(
        exp,
        train_ds.pixel_rays(),
        val_images=val_images,
        exps_root=args.exps_root,
        expname_suffix=(f"_{args.scan_id}" if args.scan_id else "") + args.append,
        expname_prefix=args.prefix,
        resume=args.resume,
        load_from=args.load_from,
        timestamp=args.timestamp,
        seed=args.seed,
        n_devices=n_ranks,
        scale=train_ds.scale,
        center=train_ds.center,
        device=device,
    )
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            trainer.train(max_iters=min(50, args.max_iters or 50))
        os.makedirs(args.profile_dir, exist_ok=True)
        if rank == 0:
            prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    trainer.train(max_iters=args.max_iters)
    if rank == 0:
        if val_images:
            print("val:", trainer.validate())
        print("mesh:", trainer.export_mesh()[0])
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(ap)
    add_data_args(ap)
    add_conf_args(ap)
    ap.add_argument("--params", default=None, help=".npz of a JAX parameter tree")
    ap.add_argument("--init_seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rays", type=int, default=1024, help="rays per step")
    ap.add_argument("--compute_dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out", default="trained_params.npz")
    args = ap.parse_args(argv)
    if args.conf:
        if args.grids or args.union or args.sweep_pe or args.params or args.data_dir:
            ap.error("--conf names the model and the scene: drop the hard-wired model flags")
        return conf_main(args)

    device = resolve_device(args.device)
    cfg = model_config(args, args.compute_dtype)
    model = init_monosdf(cfg, seed=args.init_seed, device=device)
    if args.params:
        load_jax_params(model, load_params_npz(args.params))
    step = make_trainer(model, cfg)
    scene = load_scene(args)
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

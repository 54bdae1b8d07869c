"""Parameterised training-step timing on the card (the port of
scripts/bench_step.py; ``monosdf_torch.bench`` stays the one-line metric):

    python -m monosdf_torch.scripts.bench_step [--rays 1024] [--diff jnp|pallas]
        [--sampler jnp|pallas] [--rgb jnp|fused|pallas] [--machinery jnp|pallas]
        [--iters 20] [--warmup 3] [--grid ...] [--nofold] [--nofused_opt] [--device cpu]

The model is built as the JAX script's :81-123 builds it, with its defaults:
the plain versions (``--diff jnp --sampler jnp --rgb jnp --machinery jnp``).
``--diff pallas --sampler pallas --machinery pallas --rgb fused`` is the
bench's kernel path: ``cli/eval.py bench_config(False)``, field for field;
with ``--grid --hash_scheme add --layout quad --scatter fold --fold_impl
pallas --build_impl pallas --param_flat --gather_chunks 4 --sweep_oct
--sweep_max_level 6 --sampler_iters 4 --rgb jnp`` it is ``bench_config(True)``.
Weights from seed 0; one fixed batch of ``--rays`` rays of
``make_synthetic_sphere_scene(n_images=4, img_res=64)`` at
``default_rng(0)``; the draws from a generator seeded 0. After the kernels'
build (``build_all``), ``--warmup`` steps, then ``--iters`` timed steps
from the host clock to a synchronise. Prints ONE JSON line: the JAX
script's keys (``rays``, ``diff``, ``sampler``, ``rgb``, ``sweep_pe``,
``machinery``, ``grid``, ``table_dtype``, ``scatter``, ``hash_scheme``,
``layout``, ``ms_per_step``, ``rays_per_s``, ``compile_s``: the warm-up's
seconds, ``loss_first``: the last warm-up step's loss, ``loss_last``), and
``nofold``, ``nofused_opt``, ``launches_per_step`` (the port's kernels,
counted over the timed steps) and ``device``.

Flags of scripts/bench_step.py: ``--rays``, ``--diff``, ``--sampler``,
``--rgb``, ``--sweep_pe``, ``--machinery``, ``--iters``, ``--warmup``,
``--grid``, ``--table_dtype``, ``--scatter``, ``--hash_scheme``,
``--layout``, ``--fold_impl``, ``--build_impl``, ``--param_flat``,
``--sweep_max_level``, ``--gather_chunks``, ``--sweep_oct``,
``--sampler_iters``, ``--f32``, ``--nofold`` (``MonoSDFConfig.fold_eikonal``)
and ``--nofused_opt`` (``OptimConfig.fused``: per-parameter Adam) each set
the port's field of the same name; the grid layout knobs (``--scatter``,
``--layout``, ``--fold_impl``, ``--build_impl``, ``--param_flat``,
``--gather_chunks``, ``--sweep_oct``) change no value in the port.
``--unroll K`` (K steps traced into one XLA dispatch) is left out: its
PyTorch counterpart would be the step captured in a CUDA graph, a speed
change of the step itself. The port adds ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..cli.train import ray_batches
from ..data.synthetic import make_synthetic_sphere_scene
from ..device import resolve_device
from ..kernels import build
from ..losses import LossConfig
from ..models.fields import ImplicitNetConfig, RenderingNetConfig
from ..models.monosdf import MonoSDFConfig, init_monosdf
from ..ops.hashgrid import HashGridConfig
from ..ops.sampler import SamplerConfig
from ..train import OptimConfig, make_optimizer, make_train_step

# bench_config(False)'s backends; with --grid the radiance stays plain (--rgb jnp)
KERNEL_FLAGS = ("--diff", "pallas", "--sampler", "pallas", "--machinery", "pallas",
                "--rgb", "fused")


def add_model_args(ap, kernels: bool = False):
    """The model, batch and optimizer flags of scripts/bench_step.py
    (``kernels``: the kernel path's backends as defaults)."""
    plain = "pallas" if kernels else "jnp"
    ap.add_argument("--diff", default=plain)
    ap.add_argument("--sampler", default=plain)
    ap.add_argument("--rgb", default="fused" if kernels else "jnp")
    ap.add_argument("--sweep_pe", action="store_true", help="in-kernel sweep PE (K1-PE)")
    ap.add_argument("--machinery", default=plain)
    ap.add_argument("--grid", action="store_true", help="hash-grid flagship config")
    ap.add_argument("--table_dtype", default="bfloat16", help="hash-table dtype (grid mode)")
    ap.add_argument("--scatter", default="flat", help="flat|rows|fold (grid mode; no value)")
    ap.add_argument("--hash_scheme", default="xor", help="xor|add (grid mode)")
    ap.add_argument("--layout", default="rows", help="rows|quad (grid mode; no value)")
    ap.add_argument("--fold_impl", default="xla", help="xla|pallas (grid mode; no value)")
    ap.add_argument("--build_impl", default="xla", help="xla|pallas (grid mode; no value)")
    ap.add_argument("--param_flat", action="store_true", help="grid mode: 1-D table parameter")
    ap.add_argument("--sweep_max_level", type=int, default=0,
                    help="grid mode: the sweeps read the first K levels (0: all)")
    ap.add_argument("--gather_chunks", type=int, default=1, help="grid mode (no value)")
    ap.add_argument("--sweep_oct", action="store_true", help="grid mode (no value)")
    ap.add_argument("--sampler_iters", type=int, default=5,
                    help="error-bounded sampler upsampling rounds")
    ap.add_argument("--f32", action="store_true", help="disable mixed precision")
    ap.add_argument("--nofold", action="store_true",
                    help="the eikonal points' gradient in a call of its own")
    ap.add_argument("--nofused_opt", action="store_true", help="per-parameter Adam")


def model_config(args) -> MonoSDFConfig:
    """The MonoSDFConfig of scripts/bench_step.py:81-123 on the port's configs."""
    if args.grid:
        implicit = ImplicitNetConfig(
            feature_vector_size=256, dims=(256, 256), multires=6,
            inside_outside=True, bias=0.9, use_grid=True,
            grid=HashGridConfig(
                num_levels=16, level_dim=2, base_resolution=16,
                log2_hashmap_size=19, desired_resolution=2048,
                table_dtype=args.table_dtype, scatter_impl=args.scatter,
                hash_scheme=args.hash_scheme, layout=args.layout,
                fold_impl=args.fold_impl, build_impl=args.build_impl,
                param_flat=args.param_flat, gather_chunks=args.gather_chunks,
                sweep_oct_levels=args.sweep_max_level if args.sweep_oct else 0,
            ),
            divide_factor=1.1, sdf_bounding_sphere=0.0,
        )
    else:
        implicit = ImplicitNetConfig(
            feature_vector_size=256, dims=(256,) * 8, skip_in=(4,), multires=6,
            inside_outside=True, bias=0.9, sdf_bounding_sphere=1.1,
        )
    return MonoSDFConfig(
        implicit=implicit,
        rendering=RenderingNetConfig(feature_vector_size=256, dims=(256, 256), multires_view=4),
        sampler=SamplerConfig(
            scene_bounding_sphere=1.1, N_samples=64, N_samples_eval=128, N_samples_extra=32,
            max_total_iters=args.sampler_iters, intersection="cube", machinery=args.machinery,
        ),
        compute_dtype="float32" if args.f32 else "bfloat16",
        sweep_max_level=args.sweep_max_level or None,
        mixed_precision=not args.f32,
        sampler_backend=args.sampler,
        diff_backend=args.diff,
        rgb_backend=args.rgb,
        sweep_pe_in_kernel=args.sweep_pe,
        fold_eikonal=not args.nofold,
    )


@dataclasses.dataclass
class Run:
    """A model, its training step and one fixed batch on ``device``;
    ``step()`` takes one training step and returns its metrics."""

    device: torch.device
    name: str  # the card's name, or 'cpu'
    cfg: MonoSDFConfig
    model: torch.nn.Module
    train_step: object
    batch: dict
    generator: torch.Generator

    def step(self) -> dict:
        return self.train_step(self.model, self.batch, generator=self.generator)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def setup(args) -> Run:
    """The run of ``args`` (``add_model_args``' flags, ``--rays`` and
    ``--device``): on the card the kernels are built first (``build_all``;
    a failed build raises)."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        build.build_all()
    cfg = model_config(args)
    model = init_monosdf(cfg, seed=0, device=device)
    ocfg = OptimConfig(learning_rate=5e-4, decay_steps=150_000, grid_mode=args.grid,
                       fused=not args.nofused_opt)
    train_step = make_train_step(cfg, LossConfig(), make_optimizer(ocfg, model.named_parameters()))
    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    batch = ray_batches(scene, np.random.default_rng(0), 1, args.rays, device)[0]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return Run(device, name, cfg, model, train_step, batch,
               torch.Generator(device=device).manual_seed(0))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    add_model_args(ap)
    ap.add_argument("--device", default=None, help="default: cuda")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.warmup < 1:
        raise ValueError("--warmup must be at least 1: the first step's loss is read after it")

    run = setup(args)
    t_c = time.perf_counter()
    for _ in range(args.warmup):
        metrics = run.step()
    loss0 = float(metrics["loss"])
    compile_s = time.perf_counter() - t_c

    before = dict(build.launches)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        metrics = run.step()
    run.sync()
    dt = time.perf_counter() - t0
    loss1 = float(metrics["loss"])
    launches = {k: (v - before[k]) / args.iters for k, v in build.launches.items()
                if v != before[k]}
    if not (np.isfinite(loss0) and np.isfinite(loss1)):
        raise FloatingPointError(f"bench_step: a non-finite loss ({loss0}, {loss1})")

    line = {
        "rays": args.rays, "diff": args.diff, "sampler": args.sampler,
        "rgb": args.rgb, "sweep_pe": args.sweep_pe, "machinery": args.machinery,
        "grid": args.grid,
        "table_dtype": args.table_dtype if args.grid else None,
        "scatter": args.scatter if args.grid else None,
        "hash_scheme": args.hash_scheme if args.grid else None,
        "layout": args.layout if args.grid else None,
        "nofold": args.nofold, "nofused_opt": args.nofused_opt,
        "ms_per_step": 1e3 * dt / args.iters,
        "rays_per_s": args.rays * args.iters / dt,
        "compile_s": compile_s,
        "loss_first": loss0, "loss_last": loss1,
        "launches_per_step": launches,
        "device": run.name,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

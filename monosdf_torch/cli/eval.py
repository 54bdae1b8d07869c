"""Render every view of a scene and report PSNR: the counterpart of the
``--eval_rendering`` branch of monosdf_tpu/cli/eval.py.

Each frame is rendered in chunks of ``split_n_pixels`` rays through
``models.render_rays`` (eval); per-frame PSNR is printed and written to
``<out_dir>/psnr.csv``. The model is the bench's ScanNet-MLP configuration
(``bench_mlp_config``), with ``--grids`` the hash-grid model of
``bench.py --grids`` (``bench_grids_config``), or with ``--union`` the
appearance-code model of ``confs/synth_union_quality.conf``
(``union_codes_config``: each frame renders with its own per-image code;
``--rgb_backend pallas`` takes its radiance through K8a instead of K3;
``--sweep_pe`` runs an MLP model's sampler sweeps on raw points through
K1-PE); its parameters come from
``--params`` (an ``.npz``
written by ``params.save_params_npz``, e.g. from a JAX checkpoint) or from
the port's own initialisation (``--init_seed``). The scene is the synthetic
sphere. Runs on the card unless ``--device cpu``.

    python -m monosdf_torch.cli.eval --n_images 4 --img_res 64 --out_dir evaluation
    python -m monosdf_torch.cli.eval --grids --out_dir evaluation_grids
    python -m monosdf_torch.cli.eval --union --out_dir evaluation_union
    python -m monosdf_torch.cli.eval --sweep_pe --out_dir evaluation_pe
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import numpy as np
import torch

from ..data.synthetic import make_synthetic_sphere_scene
from ..device import resolve_device
from ..eval.metrics import psnr
from ..models.fields import ImplicitNetConfig, RenderingNetConfig
from ..models.monosdf import MonoSDFConfig, init_monosdf, render_rays
from ..ops.chunking import chunked_apply
from ..ops.hashgrid import HashGridConfig
from ..ops.sampler import SamplerConfig
from ..params import load_jax_params, load_params_npz

OUTPUT_KEYS = ("rgb_values", "depth_values", "normal_map")


def bench_mlp_config(compute_dtype: str = "bfloat16") -> MonoSDFConfig:
    """The ScanNet-MLP model of bench.py's default run: 8x256 SDF MLP with a
    skip at layer 4 and PE(6), 2x256 radiance MLP with view PE(4), the
    error-bounded sampler (128-point sweeps, 5 iterations, 10 bisections,
    64+32+2 samples, cube intersection). ``compute_dtype`` bf16 runs the
    matmul operands at bf16 with float32 sums. The backends are the
    kernels' (on a CPU tensor, their plain versions)."""
    mixed = compute_dtype != "float32"
    return MonoSDFConfig(
        implicit=ImplicitNetConfig(
            feature_vector_size=256, dims=(256,) * 8, skip_in=(4,), multires=6,
            inside_outside=True, bias=0.9, sdf_bounding_sphere=1.1,
        ),
        rendering=RenderingNetConfig(feature_vector_size=256, dims=(256, 256), multires_view=4),
        sampler=SamplerConfig(
            scene_bounding_sphere=1.1, N_samples=64, N_samples_eval=128, N_samples_extra=32,
            max_total_iters=5, intersection="cube", machinery="pallas",
            machinery_dtype=compute_dtype,
        ),
        compute_dtype=compute_dtype,
        mixed_precision=mixed,
        sampler_backend="pallas",
        diff_backend="pallas",
        rgb_backend="fused",
    )


def bench_grids_config(compute_dtype: str = "bfloat16") -> MonoSDFConfig:
    """The hash-grid ScanNet model of ``bench.py --grids``: a 16-level x 2
    channel hash grid (base resolution 16 to 2048, 2^19-row hashed levels,
    the 'add' hash) feeding a 2x256 SDF trunk on [PE(6) | 32 grid features]
    (x / 1.1 into the grid, no sphere clamp), the 2x256 radiance MLP, the
    sampler at 4 iterations with sweeps over the first 6 grid levels. The
    table is read at ``compute_dtype`` (bf16: the bench's ``table_dtype``);
    the JAX package's TPU table-layout knobs are kept as the bench sets them
    and change no value. Backends: K1 and K4 in the sampler, K6/K5 and K7
    for SDF, features and gradient; the radiance MLP is the plain path
    (``rgb_backend='jnp'``, as the bench)."""
    mixed = compute_dtype != "float32"
    return MonoSDFConfig(
        implicit=ImplicitNetConfig(
            feature_vector_size=256, dims=(256, 256), multires=6, inside_outside=True, bias=0.9,
            use_grid=True, divide_factor=1.1, sdf_bounding_sphere=0.0,
            grid=HashGridConfig(
                num_levels=16, level_dim=2, base_resolution=16, log2_hashmap_size=19,
                desired_resolution=2048, table_dtype=compute_dtype, scatter_impl="fold",
                hash_scheme="add", layout="quad", fold_impl="pallas", build_impl="pallas",
                param_flat=True, gather_chunks=4, sweep_oct_levels=6,
            ),
        ),
        rendering=RenderingNetConfig(feature_vector_size=256, dims=(256, 256), multires_view=4),
        sampler=SamplerConfig(
            scene_bounding_sphere=1.1, N_samples=64, N_samples_eval=128, N_samples_extra=32,
            max_total_iters=4, intersection="cube", machinery="pallas",
            machinery_dtype=compute_dtype,
        ),
        compute_dtype=compute_dtype,
        mixed_precision=mixed,
        sweep_max_level=6,
        sampler_backend="pallas",
        diff_backend="pallas",
        rgb_backend="jnp",
    )


def union_codes_config(compute_dtype: str = "bfloat16") -> MonoSDFConfig:
    """The appearance-code model of ``confs/synth_union_quality.conf``, as
    ``monosdf_tpu.config.schema.build_configs`` builds it: 8x256 SDF MLP
    with a skip at 4 and PE(6), bias 0.6, outside-in (``inside_outside``
    False), no SDF clamp (the schema turns it off under ``white_bkgd``); a
    2x256 radiance MLP with view PE(4) and a 32-wide per-image code (1024
    rows, the ``RenderingNetConfig`` defaults); a white background; the
    sampler in the 1.1 sphere (sphere intersection, 64/128/32 samples, eps
    0.1, 10 bisections, 5 iterations). bf16 operands with float32 sums
    (or ``compute_dtype='float32'``); the kernel backends, the radiance
    through K3 (``rgb_backend='fused'``, the conf's)."""
    mixed = compute_dtype != "float32"
    return MonoSDFConfig(
        implicit=ImplicitNetConfig(
            feature_vector_size=256, dims=(256,) * 8, skip_in=(4,), multires=6,
            inside_outside=False, bias=0.6, sdf_bounding_sphere=0.0,
        ),
        rendering=RenderingNetConfig(feature_vector_size=256, dims=(256, 256), multires_view=4,
                                     per_image_code=True),
        sampler=SamplerConfig(
            scene_bounding_sphere=1.1, N_samples=64, N_samples_eval=128, N_samples_extra=32,
            eps=0.1, beta_iters=10, max_total_iters=5, intersection="sphere",
            machinery="pallas", machinery_dtype=compute_dtype,
        ),
        white_bkgd=True,
        compute_dtype=compute_dtype,
        mixed_precision=mixed,
        sampler_backend="pallas",
        diff_backend="pallas",
        rgb_backend="fused",
    )


def bench_config(grids: bool, compute_dtype: str = "bfloat16") -> MonoSDFConfig:
    return (bench_grids_config if grids else bench_mlp_config)(compute_dtype)


def model_config(args, compute_dtype: str = "bfloat16") -> MonoSDFConfig:
    """The model an entry point's flags name (``--union``, ``--grids`` or
    the bench's MLP model), with ``--rgb_backend`` when given and
    ``sweep_pe_in_kernel`` under ``--sweep_pe``."""
    if args.union:
        cfg = union_codes_config(compute_dtype)
    else:
        cfg = bench_config(args.grids, compute_dtype)
    if args.rgb_backend is not None:
        cfg = dataclasses.replace(cfg, rgb_backend=args.rgb_backend)
    if args.sweep_pe:
        cfg = dataclasses.replace(cfg, sweep_pe_in_kernel=True)
    return cfg


def add_model_args(ap):
    """The model flags of both entry points."""
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--grids", action="store_true",
                       help="the hash-grid model of bench.py --grids")
    which.add_argument("--union", action="store_true",
                       help="the appearance-code model of confs/synth_union_quality.conf")
    ap.add_argument("--rgb_backend", default=None, choices=("fused", "pallas"),
                    help="the radiance through K3 (fused; needs the MLP trunk's K2) or K8a "
                         "(pallas); default: the model's own")
    ap.add_argument("--sweep_pe", action="store_true",
                    help="the sampler sweeps on raw points, PE inside the kernel (K1-PE; MLP "
                         "models), as scripts/bench_step.py --sweep_pe")


def scene_frames(scene: dict, device) -> list:
    """Per-frame ray tensors on ``device`` and the ground-truth rgb (numpy)."""
    H, W = scene["img_res"]
    n = H * W
    frames = []
    for i in range(scene["n_images"]):
        sl = slice(i * n, (i + 1) * n)
        rays = {k: torch.from_numpy(np.ascontiguousarray(scene[k][sl])).to(device)
                for k in ("rays_o", "rays_d", "depth_scale", "pose")}
        frames.append({"frame_idx": i, "rays": rays, "rgb": scene["rgb"][sl]})
    return frames


def render_image(model, cfg: MonoSDFConfig, rays: dict, split_n_pixels: int = 1024,
                 image_code=None) -> dict:
    """rgb_values, depth_values and normal_map of one view, in chunks;
    ``image_code`` (C,): the view's per-image code, given to every ray."""

    def render_chunk(o, d, s, p):
        ic = None if image_code is None else image_code[None].expand(o.shape[0], -1)
        out = render_rays(model, cfg, {"rays_o": o, "rays_d": d, "depth_scale": s, "pose": p},
                          image_code=ic)
        return {k: out[k] for k in OUTPUT_KEYS}

    return chunked_apply(render_chunk, rays["rays_o"].shape[0], split_n_pixels,
                         rays["rays_o"], rays["rays_d"], rays["depth_scale"], rays["pose"])


def evaluate(model, cfg: MonoSDFConfig, frames: list, split_n_pixels: int = 1024):
    """Render every frame (with per-image codes, frame i with row i of
    ``rendering.embeddings``); returns ([(frame, psnr)], [render dict])."""
    rows, renders = [], []
    for fr in frames:
        code = None
        if cfg.rendering.per_image_code:
            code = model.rendering.embeddings.detach()[fr["frame_idx"]]
        out = render_image(model, cfg, fr["rays"], split_n_pixels, code)
        rows.append((fr["frame_idx"], psnr(out["rgb_values"].cpu().numpy(), fr["rgb"])))
        renders.append(out)
    return rows, renders


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(ap)
    ap.add_argument("--params", default=None, help=".npz of a JAX parameter tree")
    ap.add_argument("--init_seed", type=int, default=0)
    ap.add_argument("--n_images", type=int, default=4)
    ap.add_argument("--img_res", type=int, default=64)
    ap.add_argument("--split_n_pixels", type=int, default=1024)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out_dir", default="evaluation")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args)
    model = init_monosdf(cfg, seed=args.init_seed, device=device)
    if args.params:
        load_jax_params(model, load_params_npz(args.params))
    scene = make_synthetic_sphere_scene(n_images=args.n_images, img_res=args.img_res)
    rows, _ = evaluate(model, cfg, scene_frames(scene, device), args.split_n_pixels)
    for frame, p in rows:
        print(f"frame {frame}: psnr {p:.2f}")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "psnr.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "psnr"])
        w.writerows(rows)
        w.writerow(["mean", float(np.mean([r[1] for r in rows]))])
    return rows


if __name__ == "__main__":
    main()

"""Export the mesh of a model, then render every view of a scene and report
PSNR: the counterpart of monosdf_tpu/cli/eval.py (its mesh export and its
``--eval_rendering`` branch).

The mesh is the SDF's zero set at ``--resolution`` over the schema's
``grid_boundary`` (-1.1, 1.1), written to ``<out_dir>/surface_<res>.ply``
(``meshing.extract_mesh`` on ``meshing.mesh_sdf_fn``: on the card through
K1, and K6 in grid mode; marched by the native marcher), in the scene's
world coordinates with ``--world_space`` and ``--data_dir`` (its
``scale_mat``). Each frame is rendered in chunks of ``split_n_pixels`` rays through
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
sphere, or with ``--data_dir`` a scene directory under ``--data_root`` read
by ``data.SceneDataset`` (``--img_res H W``, ``--if_hdr`` for EXR frames and
the model's HDR output, PSNR then taken through the sRGB gamma;
``--center_crop_type``): the split's frames through ``image_rays``. Runs on
the card unless ``--device cpu``.

With ``--conf`` (and ``--conf_add``) and ``--checkpoint_dir`` it is
monosdf_tpu/cli/eval.py: the conf builds the model
(``config.build_configs``), its parameters come from the checkpoint
``--checkpoint`` (``latest``; one that either package wrote,
``train.checkpoint.load_checkpoint``), the mesh is taken over the conf's
``grid_boundary`` (world coordinates with ``--world_space``: the val
split's ``scale_mat``), and ``--eval_rendering`` renders every frame of
the conf's val split in chunks of its ``split_n_pixels`` and writes
``psnr.csv``.

    python -m monosdf_torch.cli.eval --n_images 4 --img_res 64 --out_dir evaluation
    python -m monosdf_torch.cli.eval --grids --out_dir evaluation_grids
    python -m monosdf_torch.cli.eval --union --out_dir evaluation_union
    python -m monosdf_torch.cli.eval --sweep_pe --out_dir evaluation_pe
    python -m monosdf_torch.cli.eval --union --data_root scenes --data_dir union_scene \
        --img_res 64 64 --params trained_union.npz --resolution 512 --out_dir evaluation_union
    python -m monosdf_torch.cli.eval --conf confs/synth_union_quality.conf --data_root scenes \
        --checkpoint_dir exps/<run>/checkpoints --eval_rendering --out_dir evaluation_union
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import numpy as np
import torch

from ..data.scene_dataset import DatasetConfig, SceneDataset
from ..data.synthetic import make_synthetic_sphere_scene
from ..device import resolve_device
from ..eval.metrics import psnr
from ..losses import srgb_gamma
from ..meshing import extract_mesh, mesh_sdf_fn, write_ply
from ..models.fields import ImplicitNetConfig, RenderingNetConfig
from ..models.monosdf import MonoSDFConfig, init_monosdf, render_rays
from ..ops.chunking import chunked_apply
from ..ops.hashgrid import HashGridConfig
from ..ops.sampler import SamplerConfig
from ..params import load_jax_params, load_params_npz

OUTPUT_KEYS = ("rgb_values", "depth_values", "normal_map")
GRID_BOUNDARY = (-1.1, 1.1)  # monosdf_tpu/config/schema.py:33 grid_boundary


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
    the bench's MLP model), with ``--rgb_backend`` when given,
    ``sweep_pe_in_kernel`` under ``--sweep_pe`` and the HDR radiance
    output (ReLU, ``rendering.if_hdr``) under ``--if_hdr``."""
    if args.union:
        cfg = union_codes_config(compute_dtype)
    else:
        cfg = bench_config(args.grids, compute_dtype)
    if args.rgb_backend is not None:
        cfg = dataclasses.replace(cfg, rgb_backend=args.rgb_backend)
    if args.sweep_pe:
        cfg = dataclasses.replace(cfg, sweep_pe_in_kernel=True)
    if args.if_hdr:
        cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, if_hdr=True))
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


def add_data_args(ap):
    """The scene flags of both entry points (``DatasetConfig``'s names)."""
    ap.add_argument("--data_root", default="../data", help="the directory holding --data_dir")
    ap.add_argument("--data_dir", default=None,
                    help="a scene directory (scripts/make_synthetic_scene.py's layout); "
                         "default: the synthetic sphere")
    ap.add_argument("--img_res", type=int, nargs="+", default=[64],
                    help="H W of the scene's images (the sphere: one size, square)")
    ap.add_argument("--if_hdr", action="store_true",
                    help="EXR frames, the model's HDR output and PSNR through the sRGB gamma")
    ap.add_argument("--center_crop_type", default="no_crop")
    ap.add_argument("--use_mask", action="store_true",
                    help="the scene's ImMask/ masks weight the cue losses (the union confs')")
    ap.add_argument("--n_images", type=int, default=4, help="views of the synthetic sphere")


def dataset_config(args) -> DatasetConfig:
    """The ``DatasetConfig`` of the scene flags (``--data_dir`` given; one
    ``--img_res`` size is square)."""
    H, W = (args.img_res * 2)[:2]
    return DatasetConfig(data_dir=args.data_dir, img_res=(H, W), data_root=args.data_root,
                         if_hdr=args.if_hdr, center_crop_type=args.center_crop_type,
                         use_mask=args.use_mask)


def sphere_res(args) -> int:
    """The synthetic sphere's (square) image size from ``--img_res``."""
    if len(args.img_res) > 1 and args.img_res[0] != args.img_res[1]:
        raise ValueError(f"the synthetic sphere is square; --img_res {args.img_res}")
    return args.img_res[0]


def dataset_frames(ds: SceneDataset, device) -> list:
    """The split's frames of a ``SceneDataset`` (``image_rays``) as
    ``evaluate`` takes them: rays on ``device``, the frame's index and its
    ground-truth rgb (numpy)."""
    frames = []
    for i in range(len(ds.frame_idx_list)):
        im = ds.image_rays(i)
        rays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in im["rays"].items()}
        frames.append({"frame_idx": im["frame_idx"], "rays": rays, "rgb": im["gt"]["rgb"]})
    return frames


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


def frame_psnr(cfg: MonoSDFConfig, pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR of a rendered frame; with the HDR output (``rendering.if_hdr``)
    of both images through the sRGB gamma, as monosdf_tpu/cli/eval.py:96-98."""
    if cfg.rendering.if_hdr:
        pred, gt = (srgb_gamma(torch.from_numpy(np.asarray(a, np.float32))).numpy()
                    for a in (pred, gt))
    return psnr(pred, gt)


def evaluate(model, cfg: MonoSDFConfig, frames: list, split_n_pixels: int = 1024):
    """Render every frame (with per-image codes, frame ``frame_idx`` with
    that row of ``rendering.embeddings``); returns ([(frame, psnr)],
    [render dict])."""
    rows, renders = [], []
    for fr in frames:
        code = None
        if cfg.rendering.per_image_code:
            code = model.rendering.embeddings.detach()[fr["frame_idx"]]
        out = render_image(model, cfg, fr["rays"], split_n_pixels, code)
        pred = out["rgb_values"].cpu().numpy()
        rows.append((fr["frame_idx"], frame_psnr(cfg, pred, fr["rgb"])))
        renders.append(out)
    return rows, renders


def write_psnr_csv(out_dir: str, rows: list):
    """``<out_dir>/psnr.csv``: frame, psnr rows and their mean."""
    with open(os.path.join(out_dir, "psnr.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "psnr"])
        w.writerows(rows)
        w.writerow(["mean", float(np.mean([r[1] for r in rows]))])


def conf_main(args):
    """Mesh (and with ``--eval_rendering`` render) the checkpoint of a
    ``--conf`` run (monosdf_tpu/cli/eval.py main); returns the PSNR rows."""
    from ..config import build_configs, load_conf
    from ..train.checkpoint import load_checkpoint
    from .common import dataset_config_from_conf

    if not args.checkpoint_dir:
        raise SystemExit("--conf needs --checkpoint_dir")
    device = resolve_device(args.device)
    exp = build_configs(load_conf(args.conf, args.conf_add))
    cfg = exp.model
    payload = load_checkpoint(args.checkpoint_dir, args.checkpoint)
    model = load_jax_params(init_monosdf(cfg, device=device), payload["params"])
    os.makedirs(args.out_dir, exist_ok=True)
    ds = SceneDataset(dataset_config_from_conf(exp.dataset, args.data_root, args.scan_id, "val"))
    verts, faces = extract_mesh(mesh_sdf_fn(model, cfg), resolution=args.resolution,
                                grid_boundary=exp.grid_boundary,
                                scale=ds.scale if args.world_space else None,
                                center=ds.center if args.world_space else None)
    mesh_path = os.path.join(args.out_dir, f"surface_{args.resolution}.ply")
    write_ply(mesh_path, verts, faces)
    print(f"mesh: {mesh_path} ({len(verts)} verts)")
    rows = []
    if args.eval_rendering:
        rows, _ = evaluate(model, cfg, dataset_frames(ds, device),
                           args.split_n_pixels or exp.split_n_pixels)
        for frame, p in rows:
            print(f"frame {frame}: psnr {p:.2f}")
        write_psnr_csv(args.out_dir, rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(ap)
    add_data_args(ap)
    ap.add_argument("--params", default=None, help=".npz of a JAX parameter tree")
    ap.add_argument("--init_seed", type=int, default=0)
    ap.add_argument("--split_n_pixels", type=int, default=None,
                    help="rays a render chunk (default 1024; with --conf the conf's)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out_dir", default="evaluation")
    ap.add_argument("--resolution", type=int, default=512, help="the mesh's grid resolution")
    ap.add_argument("--world_space", action="store_true",
                    help="the mesh in the scene's world coordinates (--data_dir's scale_mat)")
    ap.add_argument("--conf", default=None, help="a HOCON conf (with --checkpoint_dir)")
    ap.add_argument("--conf_add", default=None, help="an overlay conf merged over --conf")
    ap.add_argument("--checkpoint_dir", default=None, help="a run's checkpoints/ directory")
    ap.add_argument("--checkpoint", default="latest", help="the checkpoint's name (<name>.ckpt)")
    ap.add_argument("--scan_id", default="")
    ap.add_argument("--eval_rendering", action="store_true",
                    help="with --conf: render the val split's frames and write psnr.csv")
    args = ap.parse_args(argv)
    if args.conf:
        if args.grids or args.union or args.sweep_pe or args.params or args.data_dir:
            ap.error("--conf names the model and the scene: drop the hard-wired model flags")
        return conf_main(args)

    device = resolve_device(args.device)
    cfg = model_config(args)
    model = init_monosdf(cfg, seed=args.init_seed, device=device)
    if args.params:
        load_jax_params(model, load_params_npz(args.params))
    ds = SceneDataset(dataset_config(args)) if args.data_dir else None
    world = args.world_space and ds is not None
    os.makedirs(args.out_dir, exist_ok=True)
    verts, faces = extract_mesh(mesh_sdf_fn(model, cfg), resolution=args.resolution,
                                grid_boundary=GRID_BOUNDARY, scale=ds.scale if world else None,
                                center=ds.center if world else None)
    mesh_path = os.path.join(args.out_dir, f"surface_{args.resolution}.ply")
    write_ply(mesh_path, verts, faces)
    print(f"mesh: {mesh_path} ({len(verts)} verts)")
    if ds is not None:
        frames = dataset_frames(ds, device)
    else:
        frames = scene_frames(make_synthetic_sphere_scene(n_images=args.n_images,
                                                          img_res=sphere_res(args)), device)
    rows, _ = evaluate(model, cfg, frames, args.split_n_pixels or 1024)
    for frame, p in rows:
        print(f"frame {frame}: psnr {p:.2f}")
    write_psnr_csv(args.out_dir, rows)
    return rows


if __name__ == "__main__":
    main()

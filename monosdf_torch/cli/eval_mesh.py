"""Mesh benchmark CLI — the scannet_eval / replica_eval / dtu_eval
evaluate.py entry points unified (monosdf_tpu/cli/eval_mesh.py).

Usage:
    python -m monosdf_torch.cli.eval_mesh --flavor scannet \
        --mesh exps/<run>/plots/surface_*.ply --gt_mesh scans/gt.ply \
        --data_root data --data_dir scannet/scan1 --img_res 968 1296 --out results.csv

    python -m monosdf_torch.cli.eval_mesh --flavor dtu \
        --mesh mesh.ply --gt_points stl_points.npy [--mask_cull] ...

World-space conversion: when --world_space is passed the mesh is assumed
normalized and gets un-normalized with the scene's scale_mat
(scannet_eval/evaluate.py:163-167). The ScanNet refuse (rasterizer and
TSDF volume) and the DTU mask dilation run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np


def _latest(pattern: str) -> str:
    files = sorted(glob.glob(pattern), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(pattern)
    return files[-1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--flavor", choices=["scannet", "replica", "dtu", "generic"],
                    required=True)
    ap.add_argument("--mesh", required=True, help="path or glob (latest wins)")
    ap.add_argument("--gt_mesh", default=None)
    ap.add_argument("--gt_points", default=None, help="npy point cloud (DTU STL)")
    ap.add_argument("--data_root", default="data",
                    help="the directory holding --data_dir (default: data/ under the working "
                         "directory; the JAX CLI's default is ../data)")
    ap.add_argument("--data_dir", default=None,
                    help="scene dir for cameras (cull/refuse); optional")
    ap.add_argument("--img_res", type=int, nargs=2, default=None,
                    help="H W for cull/refuse projections")
    ap.add_argument("--world_space", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.05)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--pose_stride", type=int, default=10)
    ap.add_argument("--no_refuse", action="store_true")
    ap.add_argument("--align", action="store_true", help="ICP align (replica)")
    ap.add_argument("--mask_cull", action="store_true", help="DTU mask culling")
    ap.add_argument("--downsample", type=float, default=0.2)
    ap.add_argument("--max_dist", type=float, default=20.0)
    ap.add_argument("--out", default=None, help="CSV/JSON output path")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..meshing import read_ply
    from ..mesh_eval import eval_scannet, eval_replica, eval_dtu, cull_by_mask

    device = resolve_device(args.device)
    mesh_path = _latest(args.mesh)
    verts, faces = read_ply(mesh_path)
    print(f"mesh: {mesh_path} ({len(verts)} verts)")

    cameras = None
    if args.data_dir:
        from ..data.scene_dataset import DatasetConfig, SceneDataset

        cameras = SceneDataset(
            DatasetConfig(
                data_dir=args.data_dir,
                img_res=tuple(args.img_res) if args.img_res else (0, 0),
                data_root=args.data_root,
                load_images=False,
            )
        )

    if args.world_space and cameras is not None:
        sm = cameras.get_scale_mat()
        verts = verts * sm[0, 0] + sm[:3, 3][None]

    if args.flavor == "dtu":
        if args.mask_cull and cameras is not None:
            masks = cameras.load_masks()
            H, W = masks[0].shape
            verts, faces = cull_by_mask(
                verts, faces, cameras.intrinsics_all, cameras.pose_all,
                masks, H, W, device=device,
            )
        gt_points = np.load(args.gt_points)
        metrics = eval_dtu(
            verts, faces, gt_points,
            downsample_density=args.downsample, max_dist=args.max_dist,
        )
    else:
        gt_verts, gt_faces = read_ply(args.gt_mesh)
        if args.flavor == "scannet":
            if cameras is None:
                ap.error("--flavor scannet needs --data_dir: the refuse renders its cameras")
            H, W = cameras.img_res
            metrics = eval_scannet(
                verts, faces, gt_verts, gt_faces,
                cameras.intrinsics_all, cameras.pose_all, H, W,
                pose_stride=args.pose_stride, voxel=args.voxel,
                threshold=args.threshold, refuse=not args.no_refuse, device=device,
            )
        elif args.flavor == "replica":
            H, W = (cameras.img_res if cameras is not None else (None, None))
            metrics = eval_replica(
                verts, faces, gt_verts, gt_faces,
                None if cameras is None else cameras.intrinsics_all,
                None if cameras is None else cameras.pose_all,
                H, W, align=args.align, threshold=args.threshold,
            )
        else:
            from ..eval.metrics import mesh_metrics_3d

            metrics = mesh_metrics_3d(
                verts, faces, gt_verts, gt_faces, threshold=args.threshold
            )

    print(json.dumps(metrics, indent=2))
    if args.out:
        if args.out.endswith(".json"):
            with open(args.out, "w") as f:
                json.dump({"mesh": mesh_path, **metrics}, f, indent=2)
        else:
            exists = os.path.exists(args.out)
            with open(args.out, "a", newline="") as f:
                w = csv.writer(f)
                if not exists:
                    w.writerow(["mesh"] + list(metrics))
                w.writerow([mesh_path] + [metrics[k] for k in metrics])
    return metrics


if __name__ == "__main__":
    main()

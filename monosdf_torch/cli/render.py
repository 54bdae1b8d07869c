"""Trajectory video rendering CLI (reference render/ scripts;
monosdf_tpu/cli/render.py). The z-buffer runs on the card unless
``--device cpu``.

    python -m monosdf_torch.cli.render --mesh exps/<run>/plots/surface_*.ply \
        --cameras data/scan1/cameras.npz --out video \
        --n_frames 240 --shading normal --video out.mp4
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, help="path or glob (latest wins)")
    ap.add_argument("--cameras", required=True, help="cameras.npz for K + keyposes")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_frames", type=int, default=240)
    ap.add_argument("--img_res", type=int, nargs=2, default=[480, 640])
    ap.add_argument("--shading", choices=["depth", "normal", "lambert"],
                    default="normal")
    ap.add_argument("--video", default=None, help="optional mp4 output (ffmpeg)")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..meshing import read_ply
    from ..render import interpolate_poses, poses_from_cameras, render_trajectory

    device = resolve_device(args.device)
    files = sorted(glob.glob(args.mesh), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no mesh matches {args.mesh}")
    verts, faces = read_ply(files[-1])
    print(f"mesh: {files[-1]} ({len(verts)} verts)")

    Ks, keyposes = poses_from_cameras(args.cameras)
    poses = interpolate_poses(keyposes, args.n_frames)
    H, W = args.img_res
    paths = render_trajectory(
        verts, faces, Ks[0], poses, H, W, args.out,
        shading=args.shading, video_path=args.video, fps=args.fps, device=device,
    )
    print(f"wrote {len(paths)} frames -> {args.out}")
    return paths


if __name__ == "__main__":
    main()

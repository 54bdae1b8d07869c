"""ScanNet -> monosdf scene converter (monosdf_tpu/preprocess/scannet.py).

Behavioral parity with preprocess/scannet_to_monosdf.py: every ``stride``-th
frame with a finite pose; RGB center-cropped to 2*image_size then resized to
image_size; sensor depth (mm PNG) /1000, nearest-resized; unit-cube pose
normalization with 3-unit pad; ``cameras.npz`` with world_mat = K @ w2c.

Output follows the EST on-disk layout consumed by SceneDataset
(``%06d_rgb.png`` + ``%06d_depth.npy``/``%06d_normal.npy`` are produced by
the separate monocular-cue extraction step; this converter writes the
images, sensor depth and cameras). Colour frames are JPEG or PNG, read in
RGB order and written back in it (the files' pixels are cv2's); the
resizes run on ``device`` (default: the card)."""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..data.png import read_png, write_png
from ..device import resolve_device
from .common import (
    adjust_intrinsics_crop_resize,
    center_crop_resize,
    read_color,
    save_depth_vis,
    unit_cube_scale_mat,
    write_cameras,
)


def convert_scannet(
    scene_dir: str,
    out_dir: str,
    image_size: int = 384,
    stride: int = 10,
    in_hw: tuple = (968, 1296),
    device=None,
):
    """scene_dir: a ScanNet scene with frames/{color,depth,pose} +
    intrinsic/intrinsic_color.txt."""
    dev = resolve_device(device)
    color_paths = sorted(
        glob(os.path.join(scene_dir, "frames", "color", "*.jpg"))
        + glob(os.path.join(scene_dir, "frames", "color", "*.png")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
    )
    depth_paths = sorted(
        glob(os.path.join(scene_dir, "frames", "depth", "*.png")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
    )
    pose_paths = sorted(
        glob(os.path.join(scene_dir, "frames", "pose", "*.txt")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
    )
    K = np.loadtxt(os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt"))[:3, :3]

    poses = np.stack([np.loadtxt(p) for p in pose_paths])
    scale_mat = unit_cube_scale_mat(poses)
    valid = np.isfinite(poses).all(axis=(1, 2))

    crop_hw = (image_size * 2, image_size * 2)
    out_hw = (image_size, image_size)
    K_out = adjust_intrinsics_crop_resize(K, in_hw, crop_hw, out_hw)

    for sub in ("", "mask", "depth_sensor"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    Ks, out_poses = [], []
    out_index = 0
    for idx in range(len(poses)):
        if idx % stride != 0 or not valid[idx]:
            continue
        img = read_color(color_paths[idx])
        img = center_crop_resize(img, crop_hw, out_hw, "linear", device=dev)
        write_png(os.path.join(out_dir, f"{out_index:06d}_rgb.png"), img)

        write_png(
            os.path.join(out_dir, "mask", f"{out_index:03d}.png"),
            np.full((image_size, image_size, 3), 255, np.uint8),
        )

        depth = read_png(depth_paths[idx]).astype(np.float32) / 1000.0
        depth = center_crop_resize(
            # sensor depth is lower-res: scale crop window proportionally
            depth,
            (
                int(round(crop_hw[0] * depth.shape[0] / in_hw[0])),
                int(round(crop_hw[1] * depth.shape[1] / in_hw[1])),
            ),
            out_hw,
            "nearest",
            device=dev,
        )
        np.save(os.path.join(out_dir, "depth_sensor", f"{out_index:06d}.npy"), depth)
        save_depth_vis(
            os.path.join(out_dir, "depth_sensor", f"{out_index:06d}.png"), depth
        )

        Ks.append(K_out)
        out_poses.append(poses[idx])
        out_index += 1

    write_cameras(out_dir, Ks, out_poses, scale_mat)
    return out_index

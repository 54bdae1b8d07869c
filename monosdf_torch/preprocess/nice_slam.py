"""nice-slam Apartment -> monosdf converter
(monosdf_tpu/preprocess/nice_slam.py).

Parity with preprocess/nice_slam_apartment_to_monosdf.py: poses from an
open3d ``trajectory.log`` (5-line blocks: header + 4 matrix rows), every
``stride``-th frame, 720-center-crop -> 384 resize, unit-cube normalization.
Colour frames are JPEG or PNG, read and written in RGB order; the resizes
run on ``device`` (default: the card)."""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from ..data.png import write_png
from ..device import resolve_device
from .common import (
    adjust_intrinsics_crop_resize,
    center_crop_resize,
    read_color,
    unit_cube_scale_mat,
    write_cameras,
)


def read_trajectory_log(path: str) -> np.ndarray:
    """open3d .log trajectory: repeated [src tgt fitness] + 4x4 rows."""
    with open(path) as f:
        lines = f.readlines()
    poses = []
    for i in range(0, len(lines), 5):
        mat = np.array(
            list(map(float, "".join(lines[i + 1 : i + 5]).split()))
        ).reshape(4, 4)
        poses.append(mat)
    return np.stack(poses)


def convert_nice_slam(
    scene_dir: str,
    out_dir: str,
    image_size: int = 384,
    stride: int = 20,
    in_hw: tuple = (720, 1280),
    device=None,
):
    dev = resolve_device(device)
    color_paths = sorted(glob(os.path.join(scene_dir, "color", "*.jpg")))
    if not color_paths:
        color_paths = sorted(glob(os.path.join(scene_dir, "color", "*.png")))
    with open(os.path.join(scene_dir, "intrinsic.json")) as f:
        K = np.array(json.load(f)["intrinsic_matrix"]).reshape(3, 3).T
    poses = read_trajectory_log(os.path.join(scene_dir, "scene", "trajectory.log"))
    scale_mat = unit_cube_scale_mat(poses)
    valid = np.isfinite(poses).all(axis=(1, 2))

    crop_hw = (in_hw[0], in_hw[0])  # square center crop at full height
    out_hw = (image_size, image_size)
    K_out = adjust_intrinsics_crop_resize(K, in_hw, crop_hw, out_hw)

    os.makedirs(out_dir, exist_ok=True)
    Ks, out_poses = [], []
    out_index = 0
    for idx in range(min(len(poses), len(color_paths))):
        if idx % stride != 0 or not valid[idx]:
            continue
        img = read_color(color_paths[idx])
        img = center_crop_resize(img, crop_hw, out_hw, "linear", device=dev)
        write_png(os.path.join(out_dir, f"{out_index:06d}_rgb.png"), img)
        Ks.append(K_out)
        out_poses.append(poses[idx])
        out_index += 1

    write_cameras(out_dir, Ks, out_poses, scale_mat)
    return out_index

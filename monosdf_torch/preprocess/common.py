"""Shared preprocessing helpers (monosdf_tpu/preprocess/common.py):
unit-cube pose normalization, crop/resize with intrinsic adjustment,
cameras.npz writing, the visualisation PNGs, and the colour-frame reader.

Reference recipe (preprocess/scannet_to_monosdf.py:70-141,
nice_slam_apartment_to_monosdf.py:86-120): cameras are normalized so that
the camera-position bbox maps into the unit cube with 3 units of padding
(``scale = 2 / (max - min + 3)``), stored as the INVERSE transform in
``scale_mat_i``; ``world_mat_i = K @ w2c`` of the un-normalized pose.

The JAX package reads and writes images with cv2, which hands it BGR and
writes BGR back; the port reads PNG (``data/png.py``) and JPEG
(``data/jpeg.py``) in the file's own RGB order and writes that order back,
so the files' pixels are the same and no channel is flipped on the way.
Resizing runs on the device (``ops/resize.py``).
"""

from __future__ import annotations

import os

import numpy as np

from ..data.jpeg import read_jpeg
from ..data.png import read_png, write_png
from ..ops.resize import resize


def read_color(path: str) -> np.ndarray:
    """A colour frame as ``cv2.imread(path)`` reads it, in RGB order: (H, W,
    3) uint8 from a PNG or JPEG file (grey replicated, alpha dropped, 16-bit
    samples shifted to 8 bits)."""
    ext = os.path.splitext(path)[1].lower()
    img = read_jpeg(path) if ext in (".jpg", ".jpeg") else read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (2, 4):
        img = img[..., :-1]
    return np.ascontiguousarray(np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img)


def unit_cube_scale_mat(poses: np.ndarray, pad: float = 3.0) -> np.ndarray:
    """poses (N,4,4) c2w (may contain non-finite entries) -> 4x4 scale_mat.

    scale_mat takes normalized coords -> world (it is the inverse of the
    normalize transform), exactly like the reference converters."""
    valid = np.isfinite(poses).all(axis=(1, 2))
    centers = poses[valid][:, :3, 3]
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    center = (lo + hi) / 2.0
    scale = 2.0 / (np.max(hi - lo) + pad)
    norm = np.eye(4, dtype=np.float32)
    norm[:3, 3] = -center
    norm[:3] *= scale
    return np.linalg.inv(norm).astype(np.float32)


def center_crop_resize(
    img: np.ndarray, crop_hw: tuple, out_hw: tuple, interpolation: str = "area", device=None
) -> np.ndarray:
    """Center-crop to crop_hw then resize to out_hw (reference torchvision
    CenterCrop+Resize transform chain), the resize on ``device`` (default:
    the card)."""
    H, W = img.shape[:2]
    ch, cw = crop_hw
    y0, x0 = (H - ch) // 2, (W - cw) // 2
    crop = img[y0 : y0 + ch, x0 : x0 + cw]
    return resize(crop, out_hw, interpolation, device=device)


def adjust_intrinsics_crop_resize(
    K: np.ndarray, in_hw: tuple, crop_hw: tuple, out_hw: tuple
) -> np.ndarray:
    """Apply the center-crop + resize to a 3x3 K."""
    K = K.copy().astype(np.float64)
    K[0, 2] -= (in_hw[1] - crop_hw[1]) * 0.5
    K[1, 2] -= (in_hw[0] - crop_hw[0]) * 0.5
    K[0, :] *= out_hw[1] / crop_hw[1]
    K[1, :] *= out_hw[0] / crop_hw[0]
    return K


def write_cameras(out_dir: str, Ks, poses, scale_mat: np.ndarray):
    """Write cameras.npz with world_mat_i = K4 @ inv(pose), scale_mat_i."""
    cams = {}
    for i, (K, pose) in enumerate(zip(Ks, poses)):
        K4 = np.eye(4, dtype=np.float64)
        K4[:3, :3] = np.asarray(K)[:3, :3]
        cams[f"world_mat_{i}"] = (K4 @ np.linalg.inv(pose)).astype(np.float32)
        cams[f"scale_mat_{i}"] = scale_mat.astype(np.float32)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)
    return cams


def save_depth_vis(path_png: str, depth: np.ndarray):
    from ..viz.colormap import disp_colormap

    vis, _ = disp_colormap(depth, cmap_name="viridis")
    write_png(path_png, vis)


def save_normal_vis(path_png: str, normal01: np.ndarray):
    write_png(path_png, (np.clip(normal01, 0, 1) * 255).astype(np.uint8))

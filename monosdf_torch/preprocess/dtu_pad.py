"""DTU high-res cue padding (monosdf_tpu/preprocess/dtu_pad.py).

Parity with preprocess/paded_dtu.py: Omnidata cues predicted on the square
1200x1200 center crop are bilinearly upsampled to the full image height and
padded back into the 1200x1600 frame, with a validity mask marking the
padded region. The resizes run on ``device`` (default: the card)."""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..data.png import write_png
from ..device import resolve_device
from ..ops.resize import resize
from .common import read_color


def _resize_bilinear(arr: np.ndarray, hw: tuple, device=None) -> np.ndarray:
    if arr.ndim == 3:  # (C, H, W)
        return np.stack([resize(c, hw, "linear", device=device) for c in arr])
    return resize(arr, hw, "linear", device=device)


def pad_dtu_cues(
    in_dir: str, out_dir: str, H: int = 1200, W: int = 1600, device=None
):
    """in_dir: EST-layout dir with %06d_rgb.png + %06d_depth.npy +
    %06d_normal.npy on the square crop. Writes padded cues + masks."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    image_paths = sorted(glob(os.path.join(in_dir, "*_rgb.png")))
    offset = (W - H) // 2
    for idx, p in enumerate(image_paths):
        stem = os.path.basename(p).replace("_rgb.png", "")
        depth = np.load(os.path.join(in_dir, f"{stem}_depth.npy"))
        normal = np.load(os.path.join(in_dir, f"{stem}_normal.npy"))
        depth = _resize_bilinear(np.squeeze(depth), (H, H), dev)
        if normal.ndim == 3 and normal.shape[0] != 3:
            normal = normal.transpose(2, 0, 1)
        normal = _resize_bilinear(normal, (H, H), dev)

        depth_pad = np.zeros((H, W), np.float32)
        depth_pad[:, offset : offset + H] = depth
        normal_pad = np.zeros((3, H, W), np.float32)
        normal_pad[:, :, offset : offset + H] = normal
        mask = np.zeros((H, W), np.float32)
        mask[:, offset : offset + H] = 1.0

        write_png(os.path.join(out_dir, f"{idx:06d}_rgb.png"), read_color(p))
        np.save(os.path.join(out_dir, f"{idx:06d}_depth.npy"), depth_pad)
        np.save(os.path.join(out_dir, f"{idx:06d}_normal.npy"), normal_pad)
        np.save(os.path.join(out_dir, f"{idx:06d}_mask.npy"), mask)
    return len(image_paths)

"""Validation-time image dashboards and plot-data assembly
(monosdf_tpu/viz/plots.py).

Equivalent of the reference's code/utils/plots.py:27-102 (``plot()``: PNG
grids of est-vs-gt rgb / depth / normal + a merged strip + TensorBoard
images) and code/training/monosdf_train.py:488-530 (``get_plot_data``:
scale/shift-aligned depth and backprojected colored point clouds). All
host-side numpy — rendering happens upstream on device. PNGs go through
``data/png.py`` (the JAX package writes them with cv2; the pixels are the
same), the depth alignment and the HDR gamma through the port's torch
functions on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.png import write_png
from ..losses import srgb_gamma
from ..meshing.ply import write_ply
from ..ops.scale_shift import compute_scale_and_shift_1d
from .colormap import disp_colormap, normal_to_rgb


def lin2img(flat: np.ndarray, img_res) -> np.ndarray:
    """(H*W, C) or (H*W,) -> (H, W, C) / (H, W). Reference plots.py:599-601."""
    H, W = img_res
    if flat.ndim == 1 or flat.shape[-1] == 1:
        return np.asarray(flat).reshape(H, W)
    return np.asarray(flat).reshape(H, W, flat.shape[-1])


def backproject_colored_points(depth, intrinsics, rgb=None):
    """(H, W) depth + (3, 3)/(4, 4) K -> (H*W, 3 or 6) cam-space points
    [+rgb]. Reference BackprojectDepth (utils/general.py:70-98) +
    get_point_cloud (monosdf_train.py:525-530)."""
    H, W = depth.shape
    K = np.asarray(intrinsics, dtype=np.float64)[:3, :3]
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    cam = pix @ np.linalg.inv(K).T * np.asarray(depth).reshape(-1, 1)
    if rgb is not None:
        cam = np.concatenate([cam, np.asarray(rgb).reshape(-1, 3)], axis=-1)
    return cam.astype(np.float32)


def get_plot_data(render_out: dict, image: dict, img_res, align_depth=True):
    """Assemble the plot dict from a full-image render + dataset image dict.

    render_out: {"rgb", "depth", "normal"} flat (H*W, C) numpy (world-frame
    normals already rotated to camera upstream). image: dataset
    ``image_rays(i)`` dict with gt + intrinsics + pose.
    Depth is scale/shift-aligned to the monocular GT cue
    (monosdf_train.py:497-499)."""
    gt = image["gt"]
    depth = np.asarray(render_out["depth"]).reshape(-1)
    depth_gt = np.asarray(gt["depth"]).reshape(-1)
    if align_depth and (depth_gt > 0).any():
        s, t = compute_scale_and_shift_1d(
            torch.from_numpy(np.asarray(depth[None, :], np.float32)),
            torch.from_numpy(np.asarray(depth_gt[None, :], np.float32)),
            torch.from_numpy((depth_gt > 0).astype(np.float32)[None, :]),
        )
        depth = depth * float(s[0]) + float(t[0])

    data = {
        "rgb_eval": lin2img(np.asarray(render_out["rgb"]), img_res),
        "rgb_gt": lin2img(np.asarray(gt["rgb"]), img_res),
        "normal_map": lin2img((np.asarray(render_out["normal"]) + 1) / 2, img_res),
        "normal_gt": lin2img((np.asarray(gt["normal"]) + 1) / 2, img_res),
        "depth_map": lin2img(depth, img_res),
        "depth_gt": lin2img(depth_gt, img_res),
        "mask": lin2img(np.asarray(gt["mask"]).reshape(-1), img_res),
    }
    if "intrinsics" in image:
        data["pred_points"] = backproject_colored_points(
            data["depth_map"], image["intrinsics"], data["rgb_eval"]
        )
        data["gt_points"] = backproject_colored_points(
            data["depth_gt"], image["intrinsics"], data["rgb_gt"]
        )
    return data


def plot(
    plot_data: dict,
    path: str,
    epoch: int,
    img_res,
    frame_idx: int = 0,
    prefix: str = "",
    if_hdr: bool = False,
    writer=None,
    tid: int = 0,
    plot_gt: bool = True,
    save_points: bool = True,
):
    """Write est|gt PNG panels (rendering/depth/normal + merged strip),
    optionally mirror to TensorBoard, optionally dump colored point clouds.

    File naming mirrors the reference: ``{prefix}{name}_{epoch}_{idx}.png``
    and ``{prefix}merge_{epoch}_{idx}.png`` (plots.py:53-59)."""
    os.makedirs(path, exist_ok=True)
    rgb_e, rgb_g = plot_data["rgb_eval"], plot_data["rgb_gt"]
    if if_hdr:
        gamma = lambda x: np.clip(srgb_gamma(torch.from_numpy(np.asarray(x, np.float32))).numpy(),
                                  0, 1)
        rgb_e, rgb_g = gamma(rgb_e), gamma(rgb_g)

    mask = plot_data["mask"] == 1.0
    depth_e_vis, ms = disp_colormap(
        plot_data["depth_map"], valid_mask=mask, cmap_name="viridis"
    )
    depth_g_vis, _ = disp_colormap(
        plot_data["depth_gt"], valid_mask=mask, cmap_name="viridis"
    )
    to8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
    panels = {
        "rendering": np.concatenate([to8(rgb_e), to8(rgb_g)], axis=1),
        "depth": np.concatenate([depth_e_vis, depth_g_vis], axis=1),
        "normal": np.concatenate(
            [to8(plot_data["normal_map"]), to8(plot_data["normal_gt"])], axis=1
        ),
    }
    files = []
    for name, img in panels.items():
        f = os.path.join(path, f"{prefix}{name}_{epoch}_{frame_idx}.png")
        write_png(f, img)
        files.append(f)
    merged = np.concatenate(list(panels.values()), axis=1)
    write_png(os.path.join(path, f"{prefix}merge_{epoch}_{frame_idx}.png"), merged)

    if save_points and "pred_points" in plot_data:
        for tag in ("pred_points", "gt_points"):
            pts = plot_data[tag]
            write_ply(
                os.path.join(path, f"{prefix}{tag}_{epoch}_{frame_idx}.ply"),
                pts[:, :3],
                colors=pts[:, 3:6] if pts.shape[1] >= 6 else None,
            )

    if writer is not None:
        overlay = to8(plot_data["normal_map"] * 0.5 + rgb_g * 0.5)
        writer.image(f"{prefix}rgb_est/{frame_idx}", to8(rgb_e), tid)
        writer.image(
            f"{prefix}rgb_DIFF/{frame_idx}", to8(np.abs(rgb_e - rgb_g)), tid
        )
        writer.image(f"{prefix}depth_est/{frame_idx}", depth_e_vis, tid)
        writer.image(
            f"{prefix}normal_est/{frame_idx}", to8(plot_data["normal_map"]), tid
        )
        writer.image(f"{prefix}normal_est_OVERLAY/{frame_idx}", overlay, tid)
        if plot_gt:
            writer.image(f"{prefix}rgb_gt/{frame_idx}", to8(rgb_g), tid)
            writer.image(f"{prefix}depth_gt/{frame_idx}", depth_g_vis, tid)
            writer.image(
                f"{prefix}normal_gt/{frame_idx}", to8(plot_data["normal_gt"]), tid
            )
    return files

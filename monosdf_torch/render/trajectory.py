"""Result-video rendering: drive a camera trajectory over a reconstructed
mesh and write shaded frames (monosdf_tpu/render/trajectory.py).

Equivalent of the reference's open3d offscreen renderers
(render/render_tntvideos_open3d.py, render_trajectory_open3d.py) — built on
the port's software rasterizer (its z-buffer on the card unless the caller
asks for the CPU) instead of an OpenGL stack. Shading modes:

* ``depth``  — colormapped z-buffer
* ``normal`` — screen-space normals (from backprojected depth gradients)
* ``lambert`` — single-light diffuse shading of those normals

Frames are PNGs written by ``data/png.py`` (RGB; the pixels JAX's
``cv2.imwrite`` of the BGR-flipped frame stores).
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh_eval.rasterize import rasterize_depth
from ..ops.geometry import rot_to_quat_np, quat_to_rot_np


def poses_from_cameras(cameras_npz: str):
    """Extract (K, poses) from a scene's cameras.npz (world = K @ w2c)."""
    from ..ops.geometry import load_K_Rt_from_P

    cams = np.load(cameras_npz)
    n = len([k for k in cams.files if k.startswith("world_mat_")])
    Ks, poses = [], []
    for i in range(n):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        K, pose = load_K_Rt_from_P(P)
        Ks.append(K)
        poses.append(pose)
    return np.stack(Ks), np.stack(poses)


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_poses(poses: np.ndarray, n_frames: int) -> np.ndarray:
    """Smooth trajectory through the given c2w poses: slerp rotations +
    linear positions, uniformly re-timed over n_frames."""
    poses = np.asarray(poses)
    n = len(poses)
    if n == 1:
        return np.repeat(poses, n_frames, axis=0)
    quats = np.stack([rot_to_quat_np(p[:3, :3]) for p in poses])
    ts = np.linspace(0, n - 1, n_frames)
    out = []
    for t in ts:
        i = min(int(np.floor(t)), n - 2)
        f = t - i
        q = _slerp(quats[i], quats[i + 1], f)
        pos = (1 - f) * poses[i][:3, 3] + f * poses[i + 1][:3, 3]
        m = np.eye(4)
        m[:3, :3] = quat_to_rot_np(q)
        m[:3, 3] = pos
        out.append(m)
    return np.stack(out)


def _screen_normals(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Per-pixel camera-space normals from the depth buffer."""
    H, W = depth.shape
    Km = np.asarray(K)[:3, :3]
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    x = (u - Km[0, 2]) / Km[0, 0] * depth
    y = (v - Km[1, 2]) / Km[1, 1] * depth
    pts = np.stack([x, y, depth], axis=-1)
    dx = np.gradient(pts, axis=1)
    dy = np.gradient(pts, axis=0)
    n = np.cross(dy, dx)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    n[depth <= 0] = 0.0
    return n


def render_mesh_frame(
    verts, faces, K, pose, H: int, W: int, shading: str = "normal",
    light_dir=(0.4, 0.6, -0.7), device=None,
) -> np.ndarray:
    """One (H, W, 3) uint8 frame; the z-buffer on ``device``."""
    depth = rasterize_depth(verts, faces, K, pose, H, W, device=device)
    hit = depth > 0
    if shading == "depth":
        from ..viz.colormap import disp_colormap

        img, _ = disp_colormap(depth, valid_mask=hit, cmap_name="viridis")
        img[~hit] = 255
        return img
    normals = _screen_normals(depth, K)
    if shading == "normal":
        img = ((normals + 1.0) / 2.0 * 255.0).astype(np.uint8)
        img[~hit] = 255
        return img
    if shading == "lambert":
        light = np.asarray(light_dir, np.float64)
        light /= np.linalg.norm(light)
        lam = np.clip(-(normals @ light), 0.15, 1.0)
        img = (np.stack([lam] * 3, axis=-1) * 255.0).astype(np.uint8)
        img[~hit] = 255
        return img
    raise ValueError(shading)


def render_trajectory(
    verts,
    faces,
    K,
    poses,
    H: int,
    W: int,
    out_dir: str,
    shading: str = "normal",
    video_path: str | None = None,
    fps: int = 30,
    device=None,
):
    """Render every pose to out_dir/frame_%05d.png; optionally assemble an
    mp4 via ffmpeg when it is on the path."""
    from ..data.png import write_png
    from ..device import resolve_device

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, pose in enumerate(poses):
        img = render_mesh_frame(verts, faces, K, pose, H, W, shading, device=device)
        p = os.path.join(out_dir, f"frame_{i:05d}.png")
        write_png(p, img)
        paths.append(p)
    if video_path:
        import shutil
        import subprocess

        if shutil.which("ffmpeg"):
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(fps), "-i",
                 os.path.join(out_dir, "frame_%05d.png"),
                 "-pix_fmt", "yuv420p", video_path],
                check=True, capture_output=True,
            )
        else:
            print("ffmpeg not found; frames left as PNGs")
    return paths

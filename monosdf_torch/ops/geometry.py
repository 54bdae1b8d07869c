"""Camera and ray geometry (monosdf_tpu/ops/geometry.py).

The host-side camera decomposition of the data path (``load_K_Rt_from_P``,
numpy), quaternion <-> rotation conversions (torch, and numpy for single
poses), and the per-ray parts of the render path: ``lift``,
``get_camera_params`` (4x4 or (B, 7) quaternion poses),
``get_sphere_intersections`` and ``near_far_from_cube``.
"""

from __future__ import annotations

import numpy as np
import torch


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection matrix into intrinsics (4x4) and
    camera-to-world pose (4x4), float32, by an RQ decomposition (no cv2),
    as monosdf_tpu/ops/geometry.py:21-57."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    # RQ of M = K @ R (K upper-triangular) from the QR of the flipped transpose
    flip = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)
    Q, R_ = np.linalg.qr((flip @ M).T)
    K = flip @ R_.T @ flip
    R = flip @ Q.T
    # signs so that K has a positive diagonal
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R
        K = -K  # keeps K @ R = M; normalised below
    # the camera centre, the null space of P: P @ [c; 1] = 0
    c = -np.linalg.solve(M, P[:, 3])

    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)  # world-from-camera rotation
    pose[:3, 3] = c.astype(np.float32)
    return intrinsics, pose


def quat_to_rot(q):
    """Quaternions (B, 4) [w, x, y, z], normalised here -> rotations (B, 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(-1, 3, 3)


def rot_to_quat(R):
    """Rotations (B, 3, 3) -> quaternions (B, 4) [w, x, y, z] (trace > -1)."""
    w = torch.sqrt(torch.clamp(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], min=1e-12)) / 2.0
    x = (R[:, 2, 1] - R[:, 1, 2]) / (4.0 * w)
    y = (R[:, 0, 2] - R[:, 2, 0]) / (4.0 * w)
    z = (R[:, 1, 0] - R[:, 0, 1]) / (4.0 * w)
    return torch.stack([w, x, y, z], dim=-1)


def quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    """One quaternion [w, x, y, z] -> (3, 3) float32 rotation, host numpy."""
    return quat_to_rot(torch.from_numpy(np.asarray(q, np.float32)[None]))[0].numpy()


def rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """One (3, 3) rotation -> float32 quaternion [w, x, y, z], host numpy."""
    return rot_to_quat(torch.from_numpy(np.asarray(R, np.float32)[None]))[0].numpy()


def lift(x, y, z, intrinsics):
    """Pixel coords -> homogeneous camera-space points at depth z, with skew.

    x, y, z: (B, N); intrinsics: (B, 4, 4). Returns (B, N, 4)."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def get_camera_params(uv, pose, intrinsics):
    """uv (B,N,2) + pose (B,4,4) or (B,7) [quaternion | camera location] +
    intrinsics (B,4,4) -> normalised world ray directions (B,N,3) and camera
    locations (B,3)."""
    if pose.shape[1] == 7:
        cam_loc = pose[:, 4:]
        p = torch.eye(4, dtype=pose.dtype, device=pose.device).repeat(pose.shape[0], 1, 1)
        p[:, :3, :3] = quat_to_rot(pose[:, :4])
        p[:, :3, 3] = cam_loc
        pose = p
    else:
        cam_loc = pose[:, :3, 3]
    depth = torch.ones(uv.shape[:2], dtype=uv.dtype, device=uv.device)
    pixel_points_cam = lift(uv[:, :, 0], uv[:, :, 1], depth, intrinsics)
    world_coords = torch.einsum("bij,bnj->bni", pose, pixel_points_cam)[:, :, :3]
    ray_dirs = world_coords - cam_loc[:, None, :]
    ray_dirs = ray_dirs / (torch.linalg.vector_norm(ray_dirs, dim=2, keepdim=True) + 1e-12)
    return ray_dirs, cam_loc


def get_sphere_intersections(cam_loc, ray_dirs, r: float = 1.0):
    """Near/far ray-sphere intersections (R,2), discriminant clamped at 0."""
    ray_cam_dot = torch.sum(ray_dirs * cam_loc, dim=-1)
    under_sqrt = ray_cam_dot**2 - (torch.sum(cam_loc**2, dim=-1) - r**2)
    sqrt_term = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    ints = torch.stack([-sqrt_term, sqrt_term], dim=-1) - ray_cam_dot[:, None]
    return torch.clamp(ints, min=0.0)


def near_far_from_cube(rays_o, rays_d, bound: float, min_near: float = 0.0,
                       max_far: float = 1e9):
    """Slab-test ray/axis-aligned-cube intersection; misses get near=far=1e9."""
    tmin = (-bound - rays_o) / (rays_d + 1e-15)
    tmax = (bound - rays_o) / (rays_d + 1e-15)
    near = torch.amax(torch.minimum(tmin, tmax), dim=-1, keepdim=True)
    far = torch.amin(torch.maximum(tmin, tmax), dim=-1, keepdim=True)
    miss = far < near
    big = torch.full_like(near, 1e9)
    near = torch.where(miss, big, near)
    far = torch.where(miss, big, far)
    near = torch.clamp(near, min=min_near)
    far = torch.clamp(far, max=max_far)
    return near, far

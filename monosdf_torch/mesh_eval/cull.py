"""Mesh culling before benchmark evaluation: the port of
monosdf_tpu/mesh_eval/cull.py (numpy on the host), with the mask dilation
of ``cull_by_mask`` on the device.

* ``cull_by_frustum`` — drop vertices that no camera sees (reference
  replica_eval/cull_mesh.py:37-87).
* ``cull_by_mask`` — DTU object-mask culling: a vertex survives only if, in
  EVERY view, it is either outside the frustum or inside the (disk-dilated)
  object mask (reference dtu_eval/evaluate_single_scene.py:20-103).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


def _project_all(verts: np.ndarray, intr, pose):
    """verts (N,3), one camera -> (u, v, z) arrays."""
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=-1)
    cam = (w2c @ vh.T)[:3].T
    z = cam[:, 2]
    p = (np.asarray(intr)[:3, :3] @ cam.T).T
    zc = np.where(np.abs(p[:, 2]) < 1e-9, 1e-9, p[:, 2])
    return p[:, 0] / zc, p[:, 1] / zc, z


def apply_vertex_mask(verts, faces, keep: np.ndarray):
    """Keep faces whose 3 vertices all survive; reindex."""
    faces = np.asarray(faces)
    face_keep = keep[faces].all(axis=1)
    new_idx = np.full(len(verts), -1, np.int64)
    new_idx[keep] = np.arange(int(keep.sum()))
    return (
        np.asarray(verts)[keep],
        new_idx[faces[face_keep]],
    )


def cull_by_frustum(verts, faces, intrinsics, poses, H: int, W: int):
    """Keep vertices inside >=1 camera frustum (in front, inside image)."""
    verts = np.asarray(verts)
    seen = np.zeros(len(verts), bool)
    for intr, pose in zip(intrinsics, poses):
        u, v, z = _project_all(verts, intr, pose)
        seen |= (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return apply_vertex_mask(verts, faces, seen)


def disk_structure(radius: int) -> np.ndarray:
    """Boolean disk structuring element (skimage.morphology.disk analog)."""
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y) <= r * r


def binary_dilation(mask, struct: np.ndarray, device=None) -> np.ndarray:
    """``scipy.ndimage.binary_dilation(mask, structure=struct)`` (zero
    border) on ``device``, for a structuring element symmetric about its
    centre: a pixel is set where the element, centred on it, covers a set
    pixel of the mask. One convolution of counts (exact in float32 up to
    2^24 terms), then > 0."""
    dev = resolve_device(device)
    m = torch.as_tensor(np.asarray(mask, bool), dtype=torch.float32, device=dev)
    k = torch.as_tensor(np.asarray(struct, bool), dtype=torch.float32, device=dev)
    ry, rx = (k.shape[0] - 1) // 2, (k.shape[1] - 1) // 2
    hits = F.conv2d(m[None, None], k[None, None], padding=(ry, rx))[0, 0]
    return (hits > 0).cpu().numpy()


def cull_by_mask(
    verts, faces, intrinsics, poses, masks, H: int, W: int, dilate_radius: int = 12,
    device=None,
):
    """DTU-style: survive iff (outside frustum) OR (inside dilated mask),
    for ALL views. masks: list of (H, W) bool/float arrays. The dilation
    runs on ``device`` (the card unless the caller asks for the CPU)."""
    verts = np.asarray(verts)
    struct = disk_structure(dilate_radius)
    keep = np.ones(len(verts), bool)
    for intr, pose, mask in zip(intrinsics, poses, masks):
        m = binary_dilation(np.asarray(mask) > 0.5, struct, device)
        u, v, z = _project_all(verts, intr, pose)
        iu = np.clip(np.round(u).astype(np.int64), 0, W - 1)
        iv = np.clip(np.round(v).astype(np.int64), 0, H - 1)
        inside_frustum = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        in_mask = m[iv, iu]
        keep &= in_mask | ~inside_frustum
    return apply_vertex_mask(verts, faces, keep)

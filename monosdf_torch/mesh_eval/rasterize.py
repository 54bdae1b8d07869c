"""Software mesh depth rasterizer (replaces the reference's pyrender EGL
offscreen renderer, scannet_eval/evaluate.py:111-137 / postprocess/refuse.py):
the port of monosdf_tpu/mesh_eval/rasterize.py.

A z-buffer as a scatter-min on the device: every face emits a K x K grid of
candidate pixels over its screen bbox; the barycentric inside test and the
perspective-correct depth run elementwise, and the winner lands through
``Tensor.scatter_reduce_(..., "amin")`` into ``H * W + 1`` slots, the last
one the drop target of the pixels no face covers (JAX's ``mode="drop"``).
A minimum does not depend on the order of its terms, so the z-buffer is
deterministic. Faces whose bbox exceeds K x K are subdivided on the host
first (``subdivide_to_bbox``, numpy, as JAX). Chunks are not padded: a
padded face of JAX's is invalid and writes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _project(verts: np.ndarray, intr: np.ndarray, w2c: np.ndarray):
    """verts (N,3) world -> (pix (N,2), z (N,)) via K @ w2c."""
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=-1)
    cam = (w2c @ vh.T)[:3].T  # (N,3)
    z = cam[:, 2]
    K = intr[:3, :3]
    p = (K @ cam.T).T
    pix = p[:, :2] / np.maximum(np.abs(p[:, 2:]), 1e-9) * np.sign(p[:, 2:])
    return pix, z


def subdivide_to_bbox(verts: np.ndarray, faces: np.ndarray, intr, w2c,
                      max_px: int, max_rounds: int = 8):
    """Split faces (longest-edge bisection) until every face's screen bbox
    fits in max_px x max_px. Host-side numpy; returns new (verts, faces)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    for _ in range(max_rounds):
        pix, z = _project(verts, intr, w2c)
        fp = pix[faces]  # (F,3,2)
        bbox = fp.max(axis=1) - fp.min(axis=1)  # (F,2)
        behind = (z[faces] <= 0).any(axis=1)
        big = (bbox.max(axis=1) >= max_px - 1) & ~behind
        if not big.any():
            break
        fb = faces[big]
        v0, v1, v2 = verts[fb[:, 0]], verts[fb[:, 1]], verts[fb[:, 2]]
        e = np.stack([
            np.linalg.norm(v1 - v0, axis=-1),
            np.linalg.norm(v2 - v1, axis=-1),
            np.linalg.norm(v0 - v2, axis=-1),
        ], axis=-1)
        longest = e.argmax(axis=-1)  # 0:(0,1) 1:(1,2) 2:(2,0)
        a = fb[np.arange(len(fb)), longest]
        b = fb[np.arange(len(fb)), (longest + 1) % 3]
        c = fb[np.arange(len(fb)), (longest + 2) % 3]
        mid = 0.5 * (verts[a] + verts[b])
        mid_idx = len(verts) + np.arange(len(mid))
        verts = np.concatenate([verts, mid], axis=0)
        new_faces = np.concatenate([
            np.stack([a, mid_idx, c], axis=-1),
            np.stack([mid_idx, b, c], axis=-1),
        ], axis=0)
        faces = np.concatenate([faces[~big], new_faces], axis=0)
    return verts.astype(np.float32), faces.astype(np.int64)


def _raster_chunk(zbuf, tri_pix, tri_invz, H: int, W: int, K: int):
    """tri_pix (F,3,2) screen coords, tri_invz (F,3) 1/z (<=0 marks invalid),
    float32 on zbuf's device. Scatter-min the perspective-correct depth of
    the covered pixels into zbuf (H*W + 1,), in place."""
    F = tri_pix.shape[0]
    valid_tri = (tri_invz > 0).all(dim=-1)  # (F,)

    lo = torch.floor(tri_pix.min(dim=1).values)  # (F,2)
    dx = torch.arange(K, dtype=tri_pix.dtype, device=tri_pix.device)
    gx = lo[:, None, 0] + dx[None, :]  # (F,K)
    gy = lo[:, None, 1] + dx[None, :]
    px = gx[:, :, None].expand(F, K, K) + 0.5
    py = gy[:, None, :].expand(F, K, K) + 0.5

    x0, y0 = tri_pix[:, 0, 0], tri_pix[:, 0, 1]
    x1, y1 = tri_pix[:, 1, 0], tri_pix[:, 1, 1]
    x2, y2 = tri_pix[:, 2, 0], tri_pix[:, 2, 1]

    def edge(ax, ay, bx, by, cx, cy):
        # cross(b - a, c - a): positive when c is left of a->b
        return ((bx - ax)[:, None, None] * (cy - ay[:, None, None])
                - (by - ay)[:, None, None] * (cx - ax[:, None, None]))

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # (F,)
    w0 = edge(x1, y1, x2, y2, px, py)
    w1 = edge(x2, y2, x0, y0, px, py)
    w2 = edge(x0, y0, x1, y1, px, py)
    denom = torch.where(area.abs() < 1e-12, torch.ones_like(area), area)[:, None, None]
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = ((torch.minimum(torch.minimum(b0, b1), b2) >= -1e-7)
              & (area.abs()[:, None, None] > 1e-12)
              & valid_tri[:, None, None])

    invz = (b0 * tri_invz[:, 0, None, None]
            + b1 * tri_invz[:, 1, None, None]
            + b2 * tri_invz[:, 2, None, None])
    depth = 1.0 / torch.clamp(invz, min=1e-12)

    ix = torch.round(px - 0.5).to(torch.int64)
    iy = torch.round(py - 0.5).to(torch.int64)
    inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    ok = inside & inb & (invz > 1e-12)
    flat = torch.where(ok, iy * W + ix, torch.full_like(ix, H * W))  # H*W -> dropped
    return zbuf.scatter_reduce_(0, flat.reshape(-1), depth.reshape(-1), reduce="amin")


def rasterize_depth(
    verts: np.ndarray,
    faces: np.ndarray,
    intr: np.ndarray,
    pose: np.ndarray,
    H: int,
    W: int,
    max_px: int = 8,
    chunk: int = 65536,
    subdivide: bool = True,
    device=None,
) -> np.ndarray:
    """Render a (H, W) float32 depth map (0 where no surface) of the mesh
    from a camera-to-world ``pose`` with intrinsics ``intr``. The z-buffer
    runs on ``device``: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    if subdivide:
        verts, faces = subdivide_to_bbox(verts, faces, intr, w2c, max_px)
    pix, z = _project(np.asarray(verts, np.float64), intr, w2c)
    faces = np.asarray(faces, np.int64)
    tri_pix = pix[faces]  # (F,3,2)
    tri_z = z[faces]
    tri_invz = np.where(tri_z > 1e-9, 1.0 / np.maximum(tri_z, 1e-9), -1.0)

    zbuf = torch.full((H * W + 1,), float("inf"), dtype=torch.float32, device=dev)
    for s in range(0, len(faces), chunk):
        _raster_chunk(
            zbuf,
            torch.from_numpy(tri_pix[s:s + chunk].astype(np.float32)).to(dev),
            torch.from_numpy(tri_invz[s:s + chunk].astype(np.float32)).to(dev),
            H, W, max_px,
        )
    depth = zbuf[: H * W].reshape(H, W).cpu().numpy()
    depth[~np.isfinite(depth)] = 0.0
    return depth

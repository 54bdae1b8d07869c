"""TSDF fusion and the "refuse" mesh-refinement pipeline: the port of
monosdf_tpu/mesh_eval/tsdf.py.

Reference behavior (scannet_eval/evaluate.py:76-137, postprocess/refuse.py):
render the predicted mesh's depth from every evaluation pose, integrate the
depth maps into a truncated signed distance volume, and re-extract the mesh
— this carves the mesh down to what the evaluation cameras actually observe.

The volume lives on the device. One view's update is one torch expression
per slab of the (X, Y, Z) grid (project -> nearest-depth lookup ->
truncated SDF -> running weighted mean), each product and sum its own
float32 rounding, so the card and the CPU give the same bits. The voxel
centres are JAX's float32 values (float64 axes cast once), formed per slab
from the three float32 axes instead of an (N, 3) array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .rasterize import rasterize_depth

SLAB_VOXELS = 1 << 22  # voxels a slab: bounds the update's temporaries


def _integrate_slab(tsdf, weight, xs, ys, zs, depth, intr, w2c, trunc: float):
    """One fusion step over a slab, in place. tsdf, weight (S, Y, Z);
    xs (S,), ys (Y,), zs (Z,) float32 voxel-centre axes; depth (H, W);
    intr (3, 3) and w2c (3, 4) as float32-valued Python floats."""
    H, W = depth.shape
    x, y, z = xs[:, None, None], ys[None, :, None], zs[None, None, :]
    cam = [w[0] * x + w[1] * y + w[2] * z + w[3] for w in w2c]
    p = [k[0] * cam[0] + k[1] * cam[1] + k[2] * cam[2] for k in intr]
    zc = torch.where(p[2].abs() < 1e-9, torch.full_like(p[2], 1e-9), p[2])
    u = p[0] / zc
    v = p[1] / zc
    iu = torch.round(u - 0.5).to(torch.int64)
    iv = torch.round(v - 0.5).to(torch.int64)
    inb = (cam[2] > 1e-6) & (iu >= 0) & (iu < W) & (iv >= 0) & (iv < H)
    d = depth[iv.clamp(0, H - 1), iu.clamp(0, W - 1)]
    sdf = d - cam[2]
    valid = inb & (d > 0) & (sdf > -trunc)
    tsdf_obs = torch.clamp(sdf / trunc, -1.0, 1.0)
    w_new = weight + valid.to(tsdf.dtype)
    tsdf.copy_(torch.where(valid, (tsdf * weight + tsdf_obs) / torch.clamp(w_new, min=1.0), tsdf))
    weight.copy_(w_new)


class TSDFVolume:
    """Dense TSDF over an axis-aligned bbox, on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, bbox_min, bbox_max, voxel: float, trunc: float | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.origin = np.asarray(bbox_min, np.float32)
        self.voxel = float(voxel)
        self.trunc = float(trunc if trunc is not None else 3.0 * voxel)
        extent = np.asarray(bbox_max, np.float64) - self.origin
        self.dims = np.maximum(np.ceil(extent / voxel).astype(int) + 1, 2)
        # JAX's centres: float64 axes (origin + i * voxel) cast to float32
        self.axes = [
            torch.from_numpy((self.origin[i] + np.arange(self.dims[i]) * voxel)
                             .astype(np.float32)).to(self.device)
            for i in range(3)
        ]
        shape = tuple(int(n) for n in self.dims)
        self.tsdf = torch.full(shape, 1.0, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(shape, dtype=torch.float32, device=self.device)

    def integrate(self, depth: np.ndarray, intr: np.ndarray, pose: np.ndarray):
        w2c = np.linalg.inv(np.asarray(pose, np.float64)).astype(np.float32)
        w2c = [[float(a) for a in row] for row in w2c[:3]]
        K = [[float(a) for a in row] for row in np.asarray(intr, np.float32)[:3, :3]]
        d = torch.from_numpy(np.ascontiguousarray(depth, np.float32)).to(self.device)
        xs, ys, zs = self.axes
        step = max(1, SLAB_VOXELS // (len(ys) * len(zs)))
        for s in range(0, len(xs), step):
            _integrate_slab(self.tsdf[s:s + step], self.weight[s:s + step],
                            xs[s:s + step], ys, zs, d, K, w2c, self.trunc)

    def extract(self):
        from ..meshing.marching import marching_tetrahedra, weld_vertices

        tsdf = self.tsdf.cpu().numpy()
        w = self.weight.cpu().numpy()
        # Unobserved voxels must produce NO surface (o3d meshes only cells
        # with weight > 0): mark them NaN so crossings into unobserved space
        # interpolate to NaN vertices (the numpy marcher, as JAX), then drop
        # that geometry.
        tsdf = np.where(w > 0, tsdf, np.nan)
        verts, faces = marching_tetrahedra(
            tsdf, origin=self.origin, spacing=(self.voxel,) * 3, level=0.0
        )
        if len(verts):
            finite = np.isfinite(verts).all(axis=-1)
            from .cull import apply_vertex_mask

            verts, faces = apply_vertex_mask(verts, faces, finite)
        return weld_vertices(verts, faces)


def refuse_mesh(
    verts,
    faces,
    intrinsics,
    poses,
    H: int,
    W: int,
    voxel: float = 0.01,
    trunc: float | None = None,
    bbox_pad: float = 0.05,
    device=None,
):
    """Full refuse pipeline: rasterize depth from every pose, fuse, extract,
    with the z-buffer and the volume on ``device``."""
    verts = np.asarray(verts)
    vol = TSDFVolume(
        verts.min(axis=0) - bbox_pad, verts.max(axis=0) + bbox_pad, voxel, trunc, device
    )
    for intr, pose in zip(intrinsics, poses):
        depth = rasterize_depth(verts, faces, intr, pose, H, W, device=vol.device)
        vol.integrate(depth, intr, pose)
    return vol.extract()

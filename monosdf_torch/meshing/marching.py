"""Iso-surface extraction by vectorized marching tetrahedra.

Replaces the reference's skimage ``measure.marching_cubes`` dependency
(reference code/utils/plots.py:196-226) with a self-contained NumPy
implementation: each grid cube splits into 6 tetrahedra; each tetrahedron
contributes 0/1/2 triangles whose vertices are linear zero-crossing
interpolations along its edges. Triangles are oriented so normals point
toward positive SDF (outside). Fully vectorized — no per-cube Python loops.

A copy of monosdf_tpu/meshing/marching.py (numpy only; the port imports
nothing of the JAX package). ``native/marching_tets.cpp`` is its C++ twin.
"""

from __future__ import annotations

import numpy as np

# 6-tet decomposition of a unit cube. Cube corner ordering:
# bit 0 -> +x, bit 1 -> +y, bit 2 -> +z (corner index = x + 2y + 4z).
_TETS = np.array(
    [
        [0, 5, 1, 3],
        [0, 5, 3, 7],
        [0, 7, 3, 2],
        [0, 7, 2, 6],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int64,
)
# Checkerboard variant: mirroring all axes (corner c -> 7-c) on cubes with odd
# (i+j+k) parity makes face diagonals agree between neighboring cubes, so the
# extracted surface is crack-free/watertight.
_TETS_BY_PARITY = np.stack([_TETS, 7 - _TETS])  # (2, 6, 4)

# tet edges (pairs of local tet-corner indices)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# For each of the 16 inside-masks (bit i set = tet corner i inside, sdf<0):
# list of triangles, each triangle = 3 tet-edge indices into _TET_EDGES.
# Built from the canonical marching-tetrahedra case analysis; winding is fixed
# numerically afterwards, so only connectivity matters here.
_CASE_TRIS = {
    0b0000: [],
    0b1111: [],
    0b0001: [[0, 1, 2]],                    # corner 0 in: edges 01,02,03
    0b0010: [[0, 3, 4]],                    # corner 1 in: edges 01,12,13
    0b0100: [[1, 3, 5]],                    # corner 2 in: edges 02,12,23
    0b1000: [[2, 4, 5]],                    # corner 3 in: edges 03,13,23
    0b1110: [[0, 1, 2]],                    # complements
    0b1101: [[0, 3, 4]],
    0b1011: [[1, 3, 5]],
    0b0111: [[2, 4, 5]],
    # two-in cases: quad over 4 crossed edges -> 2 triangles
    0b0011: [[1, 2, 3], [3, 2, 4]],         # 0,1 in: edges 02,03,12,13
    0b0101: [[0, 2, 3], [3, 2, 5]],         # 0,2 in: edges 01,03,12,23
    0b1001: [[0, 1, 4], [4, 1, 5]],         # 0,3 in: edges 01,02,13,23
    0b0110: [[0, 1, 4], [4, 1, 5]],         # 1,2 in: edges 01,02,13,23 (mirror)
    0b1010: [[0, 2, 3], [3, 2, 5]],         # 1,3 in
    0b1100: [[1, 2, 3], [3, 2, 4]],         # 2,3 in
}

_MAX_TRIS = 2
# dense (16, 2, 3) table, -1 padded
_CASE_TABLE = np.full((16, _MAX_TRIS, 3), -1, dtype=np.int64)
for _m, _tris in _CASE_TRIS.items():
    for _t, _tri in enumerate(_tris):
        _CASE_TABLE[_m, _t] = _tri


def marching_tetrahedra(sdf: np.ndarray, origin, spacing, level: float = 0.0):
    """Extract the ``level`` iso-surface of a dense SDF grid.

    sdf: (Nx, Ny, Nz) values on a regular grid; origin: (3,) world position of
    grid[0,0,0]; spacing: scalar or (3,) cell size.
    Returns (verts (V,3) float32, faces (F,3) int64). Vertices are NOT
    deduplicated (use `weld_vertices` if needed).
    """
    sdf = np.asarray(sdf, np.float32) - level
    origin = np.broadcast_to(np.asarray(origin, np.float32), (3,))
    spacing = np.broadcast_to(np.asarray(spacing, np.float32), (3,))
    nx, ny, nz = sdf.shape

    # active cubes: sign change among the 8 corners
    s000 = sdf[:-1, :-1, :-1]
    corners_sdf = np.stack(
        [
            sdf[ix:nx - 1 + ix, iy:ny - 1 + iy, iz:nz - 1 + iz]
            for iz in (0, 1) for iy in (0, 1) for ix in (0, 1)
        ],
        axis=-1,
    )  # (..., 8) ordered corner = x + 2y + 4z
    neg = corners_sdf < 0
    active = neg.any(-1) & (~neg).any(-1)
    if not active.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    cube_idx = np.argwhere(active)  # (C, 3)
    csdf = corners_sdf[active]  # (C, 8)

    # corner world positions per active cube
    corner_off = np.array(
        [[ix, iy, iz] for iz in (0, 1) for iy in (0, 1) for ix in (0, 1)],
        np.float32,
    )  # (8,3)
    cpos = (cube_idx[:, None, :].astype(np.float32) + corner_off[None]) * spacing + origin

    # expand to tets: (C, 6, 4), selecting the parity-matched decomposition
    parity = (cube_idx.sum(-1) & 1).astype(np.int64)  # (C,)
    tets = _TETS_BY_PARITY[parity]  # (C, 6, 4)
    tsdf = np.take_along_axis(csdf[:, None, :], tets, axis=2)  # (C, 6, 4)
    tpos = np.take_along_axis(
        cpos[:, None, :, :], tets[..., None], axis=2
    )  # (C, 6, 4, 3)
    tsdf = tsdf.reshape(-1, 4)
    tpos = tpos.reshape(-1, 4, 3)

    mask = ((tsdf < 0) * np.array([1, 2, 4, 8])).sum(-1)  # (T,)
    tris = _CASE_TABLE[mask]  # (T, 2, 3) edge ids, -1 padded
    valid = tris[..., 0] >= 0  # (T, 2)
    t_idx, tri_slot = np.nonzero(valid)
    if t_idx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_edges = tris[t_idx, tri_slot]  # (F, 3) edge indices

    # interpolate zero crossings on the 3 edges of each triangle
    e = _TET_EDGES[tri_edges]  # (F, 3, 2) local corner ids
    sa = np.take_along_axis(tsdf[t_idx], e[..., 0], axis=1)  # (F, 3)
    sb = np.take_along_axis(tsdf[t_idx], e[..., 1], axis=1)
    pa = np.take_along_axis(tpos[t_idx], e[..., 0][..., None], axis=1)
    pb = np.take_along_axis(tpos[t_idx], e[..., 1][..., None], axis=1)
    denom = sa - sb
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = (sa / denom)[..., None]
    t = np.clip(t, 0.0, 1.0)
    tri_verts = pa + t * (pb - pa)  # (F, 3, 3)

    # orient: normal should point from inside (sdf<0) toward outside
    inside = (tsdf[t_idx] < 0).astype(np.float32)  # (F, 4)
    w_in = inside / np.maximum(inside.sum(-1, keepdims=True), 1)
    w_out = (1 - inside) / np.maximum((1 - inside).sum(-1, keepdims=True), 1)
    outward = np.einsum("fc,fcd->fd", w_out - w_in, tpos[t_idx])
    n = np.cross(tri_verts[:, 1] - tri_verts[:, 0], tri_verts[:, 2] - tri_verts[:, 0])
    flip = np.einsum("fd,fd->f", n, outward) < 0
    tri_verts[flip] = tri_verts[flip][:, ::-1]

    verts = tri_verts.reshape(-1, 3).astype(np.float32)
    faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return verts, faces


def weld_vertices(verts: np.ndarray, faces: np.ndarray, decimals: int = 6):
    """Merge duplicate vertices (marching tetrahedra emits per-triangle
    vertices)."""
    key = np.round(verts, decimals)
    _, first, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    new_verts = verts[first]  # representative = first occurrence
    new_faces = inverse[faces]
    # drop degenerate faces
    good = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    return new_verts.astype(np.float32), new_faces[good]

"""Alternate mesh extractors: uniform-grid, PCA-aligned high-res, and
bbox-cropped extraction (the port of monosdf_tpu/meshing/alt_extract.py).

Host-side ports of the reference's secondary extraction entry points
(code/utils/plots.py get_surface_trace :273-310, get_surface_high_res_mesh
:312-391, get_surface_by_grid :394-491, get_grid_uniform :493-505,
get_grid :506-538). These are NOT on the train/eval mainline (which uses
the sliding-crop extractor, extract.py) but are part of the reference's
public surface.

Device work is only the chunked SDF evaluation (``sdf_fn`` and its device
as in extract.py); the mesh algebra (component split, area-weighted surface
sampling, PCA frame, plane clips) is plain NumPy, replacing the reference's
trimesh calls (Trimesh.split, sample.sample_surface, slice_plane) with
self-contained implementations. The marching is the native marcher's (a
failed build raises) unless the caller passes ``native=False``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import marching_tetrahedra_native
from .extract import _device_of, _eval_points, sdf_grid_eval
from .marching import marching_tetrahedra, weld_vertices


# ---------------------------------------------------------------------------
# grids (reference plots.py:493-538)
# ---------------------------------------------------------------------------

def get_grid_uniform(resolution: int, grid_boundary=(-2.0, 2.0)):
    """Cubic uniform grid over [lo, hi]^3 (plots.py:493-505)."""
    x = np.linspace(grid_boundary[0], grid_boundary[1], resolution)
    return {"xyz": [x, x.copy(), x.copy()], "shortest_axis_index": 0,
            "shortest_axis_length": float(grid_boundary[1] - grid_boundary[0])}


def get_grid(points, resolution: int, input_min=None, input_max=None,
             eps: float = 0.1):
    """Axis grid fitted to a point cloud's bounding box (plots.py:506-538).

    The SHORTEST bbox axis gets ``resolution`` linspace points; the other two
    axes use np.arange at the same spacing (so cells are cubic and the longer
    axes get proportionally more points).
    """
    if input_min is None or input_max is None:
        input_min = np.min(points, axis=0)
        input_max = np.max(points, axis=0)
    input_min = np.asarray(input_min, np.float64)
    input_max = np.asarray(input_max, np.float64)

    shortest = int(np.argmin(input_max - input_min))
    axes = [None, None, None]
    s = np.linspace(input_min[shortest] - eps, input_max[shortest] + eps,
                    resolution)
    length = float(s.max() - s.min())
    step = length / (resolution - 1)
    axes[shortest] = s
    for d in range(3):
        if d != shortest:
            axes[d] = np.arange(input_min[d] - eps,
                                input_max[d] + step + eps, step)
    return {"xyz": axes, "shortest_axis_index": shortest,
            "shortest_axis_length": length}


# ---------------------------------------------------------------------------
# mesh algebra (NumPy replacements for the trimesh calls)
# ---------------------------------------------------------------------------

def mesh_components(verts: np.ndarray, faces: np.ndarray):
    """Connected components by shared vertices (trimesh.split(
    only_watertight=False)). Returns a list of (verts, faces) submeshes."""
    if faces.shape[0] == 0:
        return []
    parent = np.arange(verts.shape[0])

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for a, b, c in faces:
        ra, rb, rc = find(a), find(b), find(c)
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(i) for i in range(verts.shape[0])])
    out = []
    for r in np.unique(roots[faces[:, 0]]):
        fmask = roots[faces[:, 0]] == r
        f = faces[fmask]
        used = np.unique(f)
        remap = np.full(verts.shape[0], -1, np.int64)
        remap[used] = np.arange(used.shape[0])
        out.append((verts[used], remap[f]))
    return out


def mesh_topology(verts: np.ndarray, faces: np.ndarray) -> dict:
    """Topology of the LARGEST connected component: Euler characteristic
    ``V - E + F`` and genus ``(2 - chi) / 2`` (closed orientable surface).
    Returns {n_components, n_verts, n_edges, n_faces, euler, genus,
    watertight} — watertight = every edge is shared by exactly 2 faces
    (genus is only meaningful then). Used by the quality gates to assert
    the marching-tets path reproduces the GT topology class (e.g. the
    synthetic torus's genus 1)."""
    comps = mesh_components(np.asarray(verts), np.asarray(faces))
    if not comps:
        return {"n_components": 0, "n_verts": 0, "n_edges": 0, "n_faces": 0,
                "euler": 0, "genus": None, "watertight": False}
    v, f = max(comps, key=lambda c: c[1].shape[0])
    e = np.sort(
        np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0),
        axis=1,
    )
    edges, counts = np.unique(e, axis=0, return_counts=True)
    chi = int(v.shape[0] - edges.shape[0] + f.shape[0])
    watertight = bool(np.all(counts == 2))
    genus = (2 - chi) // 2 if watertight and (2 - chi) % 2 == 0 else None
    return {
        "n_components": len(comps),
        "n_verts": int(v.shape[0]),
        "n_edges": int(edges.shape[0]),
        "n_faces": int(f.shape[0]),
        "euler": chi,
        "genus": genus,
        "watertight": watertight,
    }


def mesh_area(verts: np.ndarray, faces: np.ndarray) -> float:
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    return float(0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum())


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng=None) -> np.ndarray:
    """Area-weighted uniform surface sampling
    (trimesh.sample.sample_surface)."""
    rng = rng or np.random.default_rng(0)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    tri = rng.choice(faces.shape[0], size=n, p=area / area.sum())
    r1, r2 = rng.uniform(size=(2, n))
    sq = np.sqrt(r1)
    w = np.stack([1.0 - sq, sq * (1.0 - r2), sq * r2], axis=-1)  # (n,3)
    return np.einsum("nk,nkd->nd", w, verts[faces[tri]]).astype(np.float32)


def pca_frame(pc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Principal frame of a point cloud (plots.py:345-352): rows of the
    returned (3,3) matrix are covariance eigenvectors; a negative-determinant
    frame has its last two rows swapped, exactly like the reference's
    [[1,0,0],[0,0,1],[0,1,0]] @ vecs fix. Returns (mean, vecs)."""
    mean = pc.mean(axis=0)
    c = pc - mean
    cov = c.T @ c
    _, v = np.linalg.eigh(cov)
    vecs = v.T  # rows = eigenvectors
    if np.linalg.det(vecs) < 0:
        vecs = vecs[[0, 2, 1]]
    return mean.astype(np.float32), vecs.astype(np.float32)


def _clip_triangles_halfspace(verts, faces, point, normal):
    """Keep the mesh region with dot(v - point, normal) >= 0, cutting
    triangles that straddle the plane (Sutherland-Hodgman + fan
    re-triangulation) — the geometry of trimesh.slice_plane."""
    if faces.shape[0] == 0:
        return verts, faces
    d = (verts - point[None]) @ normal  # signed distance per vertex
    out_v, out_f = [], []
    n_out = 0
    tri = verts[faces]  # (F,3,3)
    td = d[faces]  # (F,3)
    for t in range(faces.shape[0]):
        poly = []
        for i in range(3):
            a, b = tri[t, i], tri[t, (i + 1) % 3]
            da, db = td[t, i], td[t, (i + 1) % 3]
            if da >= 0:
                poly.append(a)
            if (da >= 0) != (db >= 0):
                w = da / (da - db)
                poly.append(a + w * (b - a))
        if len(poly) < 3:
            continue
        poly = np.asarray(poly, np.float32)
        out_v.append(poly)
        for k in range(1, len(poly) - 1):
            out_f.append([n_out, n_out + k, n_out + k + 1])
        n_out += len(poly)
    if not out_v:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    return np.concatenate(out_v, 0), np.asarray(out_f, np.int64)


def clip_mesh_to_box(verts, faces, bb_min, bb_max):
    """Crop a mesh to an axis-aligned box by clipping against its six planes
    (reference: trimesh.creation.box + slice_plane, plots.py:478-485)."""
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    for d in range(3):
        lo = np.zeros(3, np.float32)
        lo[d] = 1.0
        verts, faces = _clip_triangles_halfspace(verts, faces, bb_min, lo)
        verts, faces = _clip_triangles_halfspace(verts, faces, bb_max, -lo)
    return weld_vertices(verts, faces)


# ---------------------------------------------------------------------------
# extraction entry points
# ---------------------------------------------------------------------------

def _march(sdf, origin, spacing, level, native: bool):
    if native:
        return marching_tetrahedra_native(sdf, origin, spacing, level)
    return weld_vertices(*marching_tetrahedra(sdf, origin, spacing, level))


def _eval_on_axes(sdf_fn, axes, chunk, device):
    xs, ys, zs = axes
    return sdf_grid_eval(sdf_fn, np.asarray(xs, np.float32), np.asarray(ys, np.float32),
                         np.asarray(zs, np.float32), chunk=chunk, device=device)


@torch.inference_mode()
def _eval_world(sdf_fn, xs, ys, zs, vecs, mean, chunk, device):
    """sdf_fn at the aligned grid xs x ys x zs rotated back to world by the
    PCA frame (rows of ``vecs``) and ``mean``."""
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts_aligned = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    pts_world = pts_aligned @ vecs + mean[None]
    return _eval_points(sdf_fn, pts_world, chunk, device).reshape(len(xs), len(ys), len(zs))


def get_surface_trace(sdf_fn, resolution: int = 100, grid_boundary=(-2.0, 2.0),
                      level: float = 0.0, chunk: int = 131072, native: bool = True,
                      device=None):
    """Single-pass uniform-grid extraction (plots.py:273-310).

    Returns (verts, faces) or None when the level set does not cross the
    grid.
    """
    device = _device_of(sdf_fn, device)
    grid = get_grid_uniform(resolution, grid_boundary)
    xs, ys, zs = grid["xyz"]
    z = _eval_on_axes(sdf_fn, (xs, ys, zs), chunk, device)
    if z.min() > level or z.max() < level:
        return None
    spacing = float(xs[1] - xs[0])
    origin = np.array([xs[0], ys[0], zs[0]], np.float32)
    return _march(z, origin, spacing, level, native)


def get_surface_high_res_mesh(sdf_fn, resolution: int = 100, grid_boundary=(-2.0, 2.0),
                              level: float = 0.0, take_components: bool = True,
                              chunk: int = 131072, rng=None, native: bool = True, device=None):
    """Two-pass extraction: a 100^3 uniform probe mesh picks the largest
    component, whose surface samples define a PCA-aligned tight grid for the
    final high-res march (plots.py:312-391). Returns (verts, faces) or None.
    """
    device = _device_of(sdf_fn, device)
    probe = get_surface_trace(sdf_fn, 100, grid_boundary, level, chunk, native, device)
    if probe is None:
        return None
    verts, faces = probe
    if take_components:
        comps = mesh_components(verts, faces)
        verts, faces = max(comps, key=lambda vf: mesh_area(*vf))
    pc = sample_surface(verts, faces, 10_000, rng=rng)

    mean, vecs = pca_frame(pc)
    aligned = (pc - mean) @ vecs.T  # rows of vecs are the frame axes
    grid = get_grid(aligned, resolution)
    xs, ys, zs = (np.asarray(a, np.float32) for a in grid["xyz"])

    # evaluate the SDF at the aligned grid points rotated back to world
    z = _eval_world(sdf_fn, xs, ys, zs, vecs, mean, chunk, device)
    if z.min() > level or z.max() < level:
        return None
    spacing = float(xs[1] - xs[0])
    v_aligned, f = _march(z, np.zeros(3, np.float32), spacing, level, native)
    # verts are relative to the aligned grid origin: rotate back and anchor
    # at the first grid point's world position (plots.py:386-388)
    world0 = np.array([xs[0], ys[0], zs[0]], np.float32) @ vecs + mean
    return (v_aligned @ vecs + world0[None]).astype(np.float32), f


def get_surface_by_grid(grid_params, sdf_fn, resolution: int = 100, level: float = 0.0,
                        higher_res: bool = False, chunk: int = 131072, rng=None,
                        native: bool = True, device=None):
    """Extraction over an explicit world bbox (plots.py:394-491).

    grid_params: (2,3) [min; max]. The min row is scaled by 1.5 (the
    reference's `grid_params * [[1.5],[1.0]]`). higher_res=True runs the
    PCA-aligned two-pass flow and crops the result to the (scaled) bbox.
    """
    device = _device_of(sdf_fn, device)
    grid_params = np.asarray(grid_params, np.float64) * np.array([[1.5], [1.0]])
    input_min, input_max = grid_params

    if not higher_res:
        grid = get_grid(None, resolution, input_min, input_max, eps=0.0)
        xs, ys, zs = (np.asarray(a, np.float32) for a in grid["xyz"])
        z = _eval_on_axes(sdf_fn, (xs, ys, zs), chunk, device)
        if z.min() > level or z.max() < level:
            return None
        origin = np.array([xs[0], ys[0], zs[0]], np.float32)
        return _march(z, origin, float(xs[1] - xs[0]), level, native)

    # higher_res: probe at 100 over the bbox, PCA-align, march, crop to bbox
    probe_grid = get_grid(None, 100, input_min, input_max, eps=0.0)
    xs, ys, zs = (np.asarray(a, np.float32) for a in probe_grid["xyz"])
    z = _eval_on_axes(sdf_fn, (xs, ys, zs), chunk, device)
    if z.min() > level or z.max() < level:
        return None
    origin = np.array([xs[0], ys[0], zs[0]], np.float32)
    verts, faces = _march(z, origin, float(xs[1] - xs[0]), level, native)
    comps = mesh_components(verts, faces)
    verts, faces = max(comps, key=lambda vf: mesh_area(*vf))
    pc = sample_surface(verts, faces, 10_000, rng=rng)

    mean, vecs = pca_frame(pc)
    aligned = (pc - mean) @ vecs.T
    grid = get_grid(aligned, resolution, eps=0.01)
    gx, gy, gz = (np.asarray(a, np.float32) for a in grid["xyz"])
    z = _eval_world(sdf_fn, gx, gy, gz, vecs, mean, chunk, device)
    if z.min() > level or z.max() < level:
        return None
    v_aligned, f = _march(z, np.zeros(3, np.float32), float(gx[1] - gx[0]), level, native)
    world0 = np.array([gx[0], gy[0], gz[0]], np.float32) @ vecs + mean
    verts = (v_aligned @ vecs + world0[None]).astype(np.float32)
    return clip_mesh_to_box(verts, f, input_min, input_max)

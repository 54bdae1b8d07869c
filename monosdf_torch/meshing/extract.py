"""Sliding-window SDF grid evaluation and mesh extraction (the port of
monosdf_tpu/meshing/extract.py).

Reference: code/utils/plots.py get_surface_sliding (:108-226): the domain
[grid_boundary]^3 is split into crops; each crop's SDF is evaluated with a
coarse-to-fine point pyramid (a coarse dense pass, then only the points whose
parent cell lies within |sdf| < threshold of the surface are refined at each
finer level, plots.py:152-196), so most of a 512^3 grid never reaches the
network. The points go to the SDF callable's device in chunks of ``chunk``
(no padding); the grid and the marching run on the host, one crop at a time,
and the crops' meshes are concatenated. Vertices can be mapped to world
coordinates by verts / scale + center (plots.py:207-210).

``sdf_fn`` takes (N, 3) float32 points as a tensor on its device and returns
(N,) SDF values there. Its device is ``device=`` where given, else the
callable's ``device`` attribute (``mesh_sdf_fn`` sets it), else ``cuda``
(``device.resolve_device``). ``mesh_sdf_fn`` is the callable of a model: the
counterpart of the closure of monosdf_tpu/train/trainer.py:371-374, routed as
the sampler's sweeps are (K1, and K6 in grid mode, on a CUDA model).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import fields
from ..native import marching_tetrahedra_native
from .marching import marching_tetrahedra


def _device_of(sdf_fn, device) -> torch.device:
    if device is None:
        device = getattr(sdf_fn, "device", None)
    return resolve_device(device)


def _eval_points(sdf_fn, pts: np.ndarray, chunk: int, device, stats=None) -> np.ndarray:
    """sdf_fn over (N, 3) points, ``chunk`` points a call -> (N,) float32."""
    n = pts.shape[0]
    out = np.empty(n, np.float32)
    for i in range(0, n, chunk):
        x = torch.from_numpy(np.ascontiguousarray(pts[i:i + chunk])).to(device)
        out[i:i + chunk] = sdf_fn(x).reshape(-1).float().cpu().numpy()
    if stats is not None:
        stats["points"] = stats.get("points", 0) + n
    return out


def _grid_points(xs, ys, zs) -> np.ndarray:
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)


@torch.inference_mode()
def sdf_grid_eval(sdf_fn, xs, ys, zs, chunk: int = 131072, device=None,
                  stats=None) -> np.ndarray:
    """Dense evaluation of sdf_fn on the grid xs x ys x zs; returns the
    (len(xs), len(ys), len(zs)) numpy array."""
    device = _device_of(sdf_fn, device)
    out = _eval_points(sdf_fn, _grid_points(xs, ys, zs), chunk, device, stats)
    return out.reshape(len(xs), len(ys), len(zs))


@torch.inference_mode()
def sdf_grid_eval_pyramid(sdf_fn, xs, ys, zs, chunk: int = 131072, levels: int = 3,
                          threshold_scale: float = 2.0, device=None, stats=None) -> np.ndarray:
    """Coarse-to-fine masked evaluation (the reference's point pyramid,
    plots.py:152-196).

    The coarse grid (stride 2^levels) is evaluated densely; at each finer
    level only the points whose block's coarse value lies within
    ``threshold_scale * cell_diagonal`` of the surface go through the
    network, and every other point inherits that value (sign-correct far
    from the surface, which is all the marching needs). A grid whose sides
    the coarse stride does not divide is evaluated densely.
    """
    device = _device_of(sdf_fn, device)
    nx, ny, nz = len(xs), len(ys), len(zs)
    stride0 = 2 ** levels
    if (nx - 1) % stride0 or (ny - 1) % stride0 or (nz - 1) % stride0:
        return _eval_points(sdf_fn, _grid_points(xs, ys, zs), chunk, device,
                            stats).reshape(nx, ny, nz)

    spacing = float(xs[1] - xs[0]) if nx > 1 else 1.0
    sdf = np.full((nx, ny, nz), np.nan, np.float32)

    def eval_mask(mask):
        ii, jj, kk = np.nonzero(mask)
        if len(ii) == 0:
            return
        pts = np.stack([np.asarray(xs)[ii], np.asarray(ys)[jj], np.asarray(zs)[kk]],
                       axis=-1).astype(np.float32)
        sdf[ii, jj, kk] = _eval_points(sdf_fn, pts, chunk, device, stats)

    # level 0: dense at the coarsest stride
    coarse = np.zeros((nx, ny, nz), bool)
    coarse[::stride0, ::stride0, ::stride0] = True
    eval_mask(coarse)

    known = coarse.copy()
    for lvl in range(levels):
        stride = stride0 // (2 ** lvl)
        fine = stride // 2
        thresh = threshold_scale * np.sqrt(3.0) * stride * spacing

        # fill every not-yet-known point with its block's coarse value
        rep = sdf[::stride, ::stride, ::stride]
        filled = rep.repeat(stride, 0).repeat(stride, 1).repeat(stride, 2)[:nx, :ny, :nz]
        near = np.abs(filled) < thresh

        new_mask = np.zeros((nx, ny, nz), bool)
        new_mask[::fine, ::fine, ::fine] = True
        new_mask &= ~known & near
        eval_mask(new_mask)
        known |= new_mask
        # points skipped at this level inherit the coarse fill
        skipped = np.zeros((nx, ny, nz), bool)
        skipped[::fine, ::fine, ::fine] = True
        skipped &= ~known
        sdf[skipped] = filled[skipped]
        known |= skipped
    return sdf


@torch.inference_mode()
def extract_mesh(sdf_fn, resolution: int = 512, grid_boundary=(-1.1, 1.1), level: float = 0.0,
                 crop_n: int = 128, chunk: int = 131072, scale: float | None = None, center=None,
                 native: bool = True, device=None, stats: dict | None = None):
    """Extract the SDF zero-level-set mesh over the cube [lo, hi]^3.

    Mirrors get_surface_sliding's crop decomposition (plots.py:110-141): the
    resolution is split into ceil(res / crop_n) crops per axis, whose grids
    share their boundary planes so the crops stitch seamlessly; a crop of 64
    cells or more takes the pyramid. ``native``: march with the C++ marcher
    (welded vertices; a failed build raises), else with the numpy one
    (per-triangle vertices, as the JAX package without its native library).
    ``scale``/``center``: the world un-normalisation verts / scale + center
    (plots.py:207-210). ``stats``, a dict, receives the seconds of grid
    evaluation (``eval_s``) and of marching (``march_s``), the points
    evaluated (``points``), the crops and the marcher.
    Returns (verts (V,3) float32, faces (F,3) int64).
    """
    device = _device_of(sdf_fn, device)
    st = {"eval_s": 0.0, "march_s": 0.0, "points": 0, "crops": 0, "crops_marched": 0,
          "marcher": "native" if native else "numpy"}
    lo, hi = float(grid_boundary[0]), float(grid_boundary[1])
    n_crops = max(1, -(-resolution // crop_n))
    # global grid coordinates (resolution+1 points so crops share planes)
    coords = np.linspace(lo, hi, resolution + 1, dtype=np.float32)

    all_verts, all_faces = [], []
    v_offset = 0
    per = resolution // n_crops
    for ci in range(n_crops):
        for cj in range(n_crops):
            for ck in range(n_crops):
                xs = coords[ci * per:(ci + 1) * per + 1]
                ys = coords[cj * per:(cj + 1) * per + 1]
                zs = coords[ck * per:(ck + 1) * per + 1]
                t0 = time.perf_counter()
                if per >= 64:
                    sdf = sdf_grid_eval_pyramid(sdf_fn, xs, ys, zs, chunk=chunk, device=device,
                                                stats=st)
                else:
                    sdf = sdf_grid_eval(sdf_fn, xs, ys, zs, chunk=chunk, device=device, stats=st)
                st["eval_s"] += time.perf_counter() - t0
                st["crops"] += 1
                if (sdf > level).all() or (sdf < level).all():
                    continue
                spacing = np.array([xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]], np.float32)
                origin = np.array([xs[0], ys[0], zs[0]], np.float32)
                t0 = time.perf_counter()
                march = marching_tetrahedra_native if native else marching_tetrahedra
                verts, faces = march(sdf, origin, spacing, level)
                st["march_s"] += time.perf_counter() - t0
                st["crops_marched"] += 1
                if verts.shape[0] == 0:
                    continue
                all_verts.append(verts)
                all_faces.append(faces + v_offset)
                v_offset += verts.shape[0]
    if stats is not None:
        stats.update(st)

    if not all_verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts = np.concatenate(all_verts, 0)
    faces = np.concatenate(all_faces, 0)
    if scale is not None:
        verts = verts / scale + np.asarray(center, np.float32)[None]
    return verts, faces


def mesh_sdf_fn(model, cfg):
    """The SDF callable a mesh export evaluates for a MonoSDF ``model`` and
    its ``cfg`` (monosdf_tpu/train/trainer.py:371-374, cli/eval.py:58-59:
    ``sdf_value`` at dtype None), routed as ``models.monosdf.sample_rays``
    routes the sweeps: with ``sampler_backend='pallas'`` through K1
    (``fields.sdf_value_pallas``, K1-PE under ``sweep_pe_in_kernel``; the
    sphere clamp after it) or in grid mode through K6 and K1 with every
    level (``fields.sdf_value_pallas_grid``, ``max_level=None``), else
    through ``fields.sdf_value``. Always float32 (on the card: K1's float32
    SIMT kernel). K1's weights, and in grid mode the read table, are resolved
    once here, for every chunk of the extraction. The callable carries the
    model's ``device``."""
    imp, imp_cfg = model.implicit, cfg.implicit
    if cfg.sampler_backend == "pallas":
        with torch.no_grad():
            weights = fields.sweep_weights(imp, imp_cfg)
            table = fields.grid_table(imp, imp_cfg)
        if imp_cfg.use_grid:

            def sdf_fn(pts):
                return fields.sdf_value_pallas_grid(imp, imp_cfg, pts, None, None, weights,
                                                    table)[..., 0]
        else:
            def sdf_fn(pts):
                return fields.sdf_value_pallas(imp, imp_cfg, pts, None, cfg.sweep_pe_in_kernel,
                                               weights)[..., 0]
    else:
        def sdf_fn(pts):
            return fields.sdf_value(imp, imp_cfg, pts)[..., 0]
    sdf_fn.device = next(model.parameters()).device
    return sdf_fn

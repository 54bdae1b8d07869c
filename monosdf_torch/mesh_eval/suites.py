"""Per-dataset mesh benchmark suites: the port of
monosdf_tpu/mesh_eval/suites.py (numpy and scipy on the host, the
ScanNet refuse on the device).

Flavors (matching the reference's external eval pipelines):

* ScanNet (scannet_eval/evaluate.py): world-space mesh -> TSDF "refuse"
  against every k-th eval pose -> Acc/Comp/Prec/Recall/F-score@threshold vs
  a GT mesh.
* Replica (replica_eval/eval_recon.py + cull_mesh.py): frustum cull ->
  optional ICP alignment -> GT-bbox crop -> accuracy/completion (cm),
  completion ratio & precision @5cm, F-score, normal consistency.
* DTU (dtu_eval/eval.py): mask cull upstream; surface samples downsampled
  on a radius grid, distances truncated at max_dist, optional ObsMask /
  ground-plane filtering; acc/comp/overall (Chamfer, mm).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..eval.metrics import mesh_metrics_3d, sample_mesh_surface
from .cull import apply_vertex_mask, cull_by_frustum
from .tsdf import refuse_mesh


# ---------------------------------------------------------------------------
# alignment + cropping helpers
# ---------------------------------------------------------------------------

def _rigid_fit(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid transform src->dst (Kabsch/Umeyama, no scale)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


def icp_align(
    src_pts: np.ndarray,
    dst_pts: np.ndarray,
    iters: int = 20,
    max_corr_dist: float | None = None,
    sample: int = 50_000,
    seed: int = 0,
):
    """Point-to-point ICP; returns a 4x4 transform taking src into dst
    (reference replica_eval/eval_recon.py ICP option)."""
    rng = np.random.default_rng(seed)
    if len(src_pts) > sample:
        src_pts = src_pts[rng.choice(len(src_pts), sample, replace=False)]
    tree = cKDTree(dst_pts)
    T = np.eye(4)
    cur = src_pts.copy()
    for _ in range(iters):
        d, idx = tree.query(cur)
        if max_corr_dist is not None:
            keep = d < max_corr_dist
            if keep.sum() < 10:
                break
        else:
            keep = np.ones(len(cur), bool)
        R, t = _rigid_fit(cur[keep], dst_pts[idx[keep]])
        cur = cur @ R.T + t
        Ti = np.eye(4)
        Ti[:3, :3], Ti[:3, 3] = R, t
        T = Ti @ T
    return T


def transform_points(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def crop_to_bbox(pts, extra, bbox_min, bbox_max, pad: float = 0.0):
    keep = np.all(
        (pts >= np.asarray(bbox_min) - pad) & (pts <= np.asarray(bbox_max) + pad),
        axis=-1,
    )
    return pts[keep], (None if extra is None else extra[keep])


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def eval_scannet(
    verts_pred,
    faces_pred,
    verts_gt,
    faces_gt,
    intrinsics,
    poses,
    H: int,
    W: int,
    pose_stride: int = 10,
    voxel: float = 0.01,
    threshold: float = 0.05,
    n_samples: int = 200_000,
    refuse: bool = True,
    device=None,
) -> dict:
    """ScanNet protocol: TSDF-refuse with every ``pose_stride``-th pose, then
    5cm F-score family vs the GT mesh (scannet_eval/evaluate.py:29-56,146-196).
    The refuse's z-buffer and volume run on ``device`` (the card unless the
    caller asks for the CPU)."""
    if refuse:
        sel = slice(None, None, pose_stride)
        verts_pred, faces_pred = refuse_mesh(
            verts_pred, faces_pred, intrinsics[sel], poses[sel], H, W, voxel=voxel,
            device=device,
        )
    m = mesh_metrics_3d(
        verts_pred, faces_pred, verts_gt, faces_gt,
        n_samples=n_samples, threshold=threshold,
    )
    m["recall"] = m.pop("completion_ratio")
    return m


def eval_replica(
    verts_pred,
    faces_pred,
    verts_gt,
    faces_gt,
    intrinsics=None,
    poses=None,
    H: int | None = None,
    W: int | None = None,
    align: bool = False,
    crop: bool = True,
    threshold: float = 0.05,
    n_samples: int = 200_000,
) -> dict:
    """Replica protocol: frustum cull (when cameras given) -> optional ICP ->
    GT bbox crop -> 3D metrics + normal consistency
    (replica_eval/eval_recon.py:109-193, cull_mesh.py)."""
    if intrinsics is not None and poses is not None and H and W:
        verts_pred, faces_pred = cull_by_frustum(
            verts_pred, faces_pred, intrinsics, poses, H, W
        )
    if align:
        pp, _ = sample_mesh_surface(verts_pred, faces_pred, 20_000)
        pg, _ = sample_mesh_surface(verts_gt, faces_gt, 20_000)
        T = icp_align(pp, pg)
        verts_pred = transform_points(np.asarray(verts_pred), T)
    if crop:
        lo, hi = np.asarray(verts_gt).min(axis=0), np.asarray(verts_gt).max(axis=0)
        keep = np.all(
            (np.asarray(verts_pred) >= lo - 0.05)
            & (np.asarray(verts_pred) <= hi + 0.05),
            axis=-1,
        )
        verts_pred, faces_pred = apply_vertex_mask(verts_pred, faces_pred, keep)
    m = mesh_metrics_3d(
        verts_pred, faces_pred, verts_gt, faces_gt,
        n_samples=n_samples, threshold=threshold,
    )
    # Replica reports distances in cm
    m["accuracy_cm"] = m["accuracy"] * 100.0
    m["completion_cm"] = m["completion"] * 100.0
    return m


def _grid_downsample(pts: np.ndarray, radius: float) -> np.ndarray:
    """Keep ~one point per radius-cell (DTUeval's radius-NN downsample
    analog, dtu_eval/eval.py:49-71)."""
    cell = np.floor(pts / radius).astype(np.int64)
    _, first = np.unique(cell, axis=0, return_index=True)
    return pts[np.sort(first)]


def eval_dtu(
    verts_pred,
    faces_pred,
    gt_points: np.ndarray,
    downsample_density: float = 0.2,
    max_dist: float = 20.0,
    obs_mask: dict | None = None,
    ground_plane: np.ndarray | None = None,
    n_samples: int = 1_000_000,
) -> dict:
    """DTU protocol (units mm): acc = mean trunc dist mesh->GT-points,
    comp = GT->mesh, overall = mean (dtu_eval/eval.py:42-158).

    obs_mask: optional {"mask": bool (X,Y,Z), "bb": (3,), "res": float} —
    accuracy only counted inside the observability volume.
    ground_plane: optional (4,) plane; completeness only counted above it.
    """
    pred_pts, _ = sample_mesh_surface(
        np.asarray(verts_pred), np.asarray(faces_pred), n_samples
    )
    pred_pts = _grid_downsample(pred_pts, downsample_density)
    gt_points = np.asarray(gt_points)

    # accuracy direction, restricted to observed space
    acc_pts = pred_pts
    if obs_mask is not None:
        bb = np.asarray(obs_mask["bb"], np.float64)
        res = float(obs_mask["res"])
        mask = np.asarray(obs_mask["mask"])
        cell = np.floor((acc_pts - bb) / res).astype(np.int64)
        inb = np.all((cell >= 0) & (cell < np.asarray(mask.shape)), axis=-1)
        ok = np.zeros(len(acc_pts), bool)
        ok[inb] = mask[tuple(cell[inb].T)]
        acc_pts = acc_pts[ok]
    d2s = cKDTree(gt_points).query(acc_pts)[0] if len(acc_pts) else np.array([max_dist])
    d2s = np.minimum(d2s, max_dist)

    comp_pts = gt_points
    if ground_plane is not None:
        above = (
            comp_pts @ np.asarray(ground_plane[:3]) + float(ground_plane[3])
        ) > 0
        comp_pts = comp_pts[above]
    s2d = cKDTree(pred_pts).query(comp_pts)[0] if len(pred_pts) else np.array([max_dist])
    s2d = np.minimum(s2d, max_dist)

    acc, comp = float(d2s.mean()), float(s2d.mean())
    return {
        "accuracy": acc,
        "completion": comp,
        "overall": 0.5 * (acc + comp),
        "n_pred": int(len(pred_pts)),
        "n_gt": int(len(gt_points)),
    }

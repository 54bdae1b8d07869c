"""Mesh and rendering metrics (numpy and scipy): a copy of
monosdf_tpu/eval/metrics.py (the port imports nothing of the JAX package).

Reference protocols:
* Replica 3D metrics — accuracy/completion (cm), completion ratio & precision
  @5cm, F-score, normal consistency over 200k surface samples with KDTree NN
  (reference replica_eval/eval_recon.py:109-193).
* ScanNet — Acc/Comp/Prec/Recall/F-score @5cm (scannet_eval/evaluate.py:29-56).
* DTU Chamfer — (mean d2s + mean s2d)/2 (dtu_eval/eval.py:36-38,157-158).
* PSNR (rend_util.py:17-24).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(img1) - np.asarray(img2)) ** 2))
    if mse == 0:
        return float("inf")
    return float(-10.0 * np.log10(mse))


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0):
    """Uniform area-weighted surface samples; returns (points (n,3),
    face normals at samples (n,3))."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    total = area.sum()
    if total <= 0:
        raise ValueError("degenerate mesh")
    probs = area / total
    fidx = rng.choice(len(faces), size=n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = v0[fidx] + u * (v1[fidx] - v0[fidx]) + v * (v2[fidx] - v0[fidx])
    normals = cross[fidx]
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(norm, 1e-12)
    return pts.astype(np.float32), normals.astype(np.float32)


def chamfer_distance(pts_a: np.ndarray, pts_b: np.ndarray):
    """Returns (mean a->b, mean b->a, chamfer = (a2b + b2a)/2)."""
    d_ab = cKDTree(pts_b).query(pts_a)[0]
    d_ba = cKDTree(pts_a).query(pts_b)[0]
    a2b, b2a = float(d_ab.mean()), float(d_ba.mean())
    return a2b, b2a, 0.5 * (a2b + b2a)


def f_score(pts_pred: np.ndarray, pts_gt: np.ndarray, threshold: float = 0.05):
    """Precision/recall/F-score at a distance threshold
    (replica_eval/eval_recon.py:138-179, scannet_eval/evaluate.py:29-56)."""
    d_pred_gt = cKDTree(pts_gt).query(pts_pred)[0]   # accuracy direction
    d_gt_pred = cKDTree(pts_pred).query(pts_gt)[0]   # completion direction
    precision = float((d_pred_gt < threshold).mean())
    recall = float((d_gt_pred < threshold).mean())
    if precision + recall == 0:
        return precision, recall, 0.0
    return precision, recall, 2 * precision * recall / (precision + recall)


def normal_consistency(
    pts_pred, normals_pred, pts_gt, normals_gt
) -> float:
    """Mean |cos| between matched-nearest-neighbor normals, symmetrized
    (replica_eval/eval_recon.py:152-176)."""
    idx_pg = cKDTree(pts_gt).query(pts_pred)[1]
    idx_gp = cKDTree(pts_pred).query(pts_gt)[1]
    nc_pg = np.abs(np.sum(normals_pred * normals_gt[idx_pg], axis=-1)).mean()
    nc_gp = np.abs(np.sum(normals_gt * normals_pred[idx_gp], axis=-1)).mean()
    return float(0.5 * (nc_pg + nc_gp))


def mesh_metrics_3d(
    verts_pred, faces_pred, verts_gt, faces_gt,
    n_samples: int = 200_000, threshold: float = 0.05, seed: int = 0,
) -> dict:
    """Full Replica-style 3D metric suite between two meshes."""
    pp, np_pred = sample_mesh_surface(verts_pred, faces_pred, n_samples, seed)
    pg, np_gt = sample_mesh_surface(verts_gt, faces_gt, n_samples, seed + 1)
    acc, comp, chamfer = chamfer_distance(pp, pg)
    d_pred_gt = cKDTree(pg).query(pp)[0]
    d_gt_pred = cKDTree(pp).query(pg)[0]
    precision = float((d_pred_gt < threshold).mean())
    ratio = float((d_gt_pred < threshold).mean())  # completion ratio
    fs = (
        0.0
        if precision + ratio == 0
        else 2 * precision * ratio / (precision + ratio)
    )
    nc = normal_consistency(pp, np_pred, pg, np_gt)
    return {
        "accuracy": acc,
        "completion": comp,
        "chamfer": chamfer,
        "precision": precision,
        "completion_ratio": ratio,
        "f_score": fs,
        "normal_consistency": nc,
    }

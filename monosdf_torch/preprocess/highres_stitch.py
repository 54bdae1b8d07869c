"""High-resolution monocular-cue stitching (TnT 1080p pipeline;
monosdf_tpu/preprocess/highres_stitch.py).

Parity with preprocess/generate_high_res_map.py: Omnidata only accepts 384²
inputs, so 1080p frames are cut into overlapping square patches
(``create_patches``, reference :240-267), cues are predicted per patch
(externally), and ``merge_patches`` re-assembles full-res cue maps by
chaining per-overlap alignments: least-squares scale/shift for depth,
Kabsch best-fit rotation for normals, linear blending over the overlap
(reference align_x/align_y/align_normal_* :93-174), with a final global
alignment against the center patch. The least-squares and Kabsch steps
run in float64 numpy on the host, as in the JAX package; the final resize
of the stitched map runs on ``device`` (default: the card)."""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..device import resolve_device
from ..ops.resize import resize


def _lsq_scale_shift(pred: np.ndarray, target: np.ndarray):
    """Closed-form scale/shift minimizing ||s*pred + t - target||^2."""
    a00 = float((pred * pred).sum())
    a01 = float(pred.sum())
    a11 = float(pred.size)
    b0 = float((pred * target).sum())
    b1 = float(target.sum())
    det = a00 * a11 - a01 * a01
    if abs(det) < 1e-9 * max(a00 * a11, 1.0):
        # constant overlap: scale is unobservable, align by shift only
        return 1.0, float(target.mean() - pred.mean())
    return (a11 * b0 - a01 * b1) / det, (-a01 * b0 + a00 * b1) / det


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(N,3) -> (N,3) best-fit rotation (no centering: normals are
    directions; reference best_fit_transform :67-87)."""
    H = src.T @ dst
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = Vt.T @ U.T
    return R


def _blend(a: np.ndarray, b: np.ndarray, overlap: int, axis: int):
    """Concatenate a and b along axis with linear cross-fade over overlap."""
    w_shape = [1] * a.ndim
    w_shape[axis] = overlap
    w = np.linspace(1.0, 0.0, overlap).reshape(w_shape)
    a_main, a_ov = np.split(a, [a.shape[axis] - overlap], axis=axis)
    b_ov, b_main = np.split(b, [overlap], axis=axis)
    mid = a_ov * w + b_ov * (1.0 - w)
    return np.concatenate([a_main, mid, b_main], axis=axis)


def align_depth(d1: np.ndarray, d2: np.ndarray, overlap: int, axis: int):
    """Scale/shift-align d2 to d1 over the trailing/leading overlap strips
    and blend (reference align_x/align_y)."""
    ov1 = np.take(d1, range(d1.shape[axis] - overlap, d1.shape[axis]), axis=axis)
    ov2 = np.take(d2, range(overlap), axis=axis)
    s, t = _lsq_scale_shift(ov2, ov1)
    return _blend(d1, s * d2 + t, overlap, axis)


def align_normal(n1: np.ndarray, n2: np.ndarray, overlap: int, axis: int):
    """Rotate n2's normals onto n1 over the overlap and blend; n*: (H,W,3)."""
    ov1 = np.take(n1, range(n1.shape[axis] - overlap, n1.shape[axis]), axis=axis)
    ov2 = np.take(n2, range(overlap), axis=axis)
    R = _kabsch(ov2.reshape(-1, 3), ov1.reshape(-1, 3))
    n2r = n2 @ R.T
    out = _blend(n1, n2r, overlap, axis)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-15)


def create_patches(
    image: np.ndarray, patch: int = 360, stride: int = 120
):
    """(H,W,C) -> dict {(row, col): patch}, plus the center patch under key
    'mid' used for final global alignment."""
    H, W = image.shape[:2]
    ny = H // stride - (patch // stride - 1)
    nx = W // stride - (patch // stride - 1)
    out = {}
    for j in range(ny):
        for i in range(nx):
            out[(j, i)] = image[
                j * stride : j * stride + patch, i * stride : i * stride + patch
            ]
    out["mid"] = image[
        H // 2 - patch // 2 : H // 2 + patch // 2,
        W // 2 - patch // 2 : W // 2 + patch // 2,
    ]
    return out


def merge_patches(
    patches: dict,
    kind: str,
    patch: int = 360,
    stride: int = 120,
):
    """Stitch {(row, col): cue} patch maps back to the full frame.

    kind: 'depth' (H,W) float patches -> scale/shift chain; 'normal'
    (H,W,3) -> rotation chain. Rows are chained left->right, then rows
    top->bottom; finally the map is re-aligned to the 'mid' patch when
    present."""
    assert kind in ("depth", "normal")
    keys = [k for k in patches if isinstance(k, tuple)]
    ny = max(k[0] for k in keys) + 1
    nx = max(k[1] for k in keys) + 1
    overlap = patch - stride
    align = align_depth if kind == "depth" else align_normal

    rows = []
    for j in range(ny):
        row = patches[(j, 0)].astype(np.float64)
        for i in range(1, nx):
            row = align(row, patches[(j, i)].astype(np.float64), overlap, 1)
        rows.append(row)
    full = rows[0]
    for j in range(1, ny):
        full = align(full, rows[j], overlap, 0)

    if "mid" in patches:
        H, W = full.shape[:2]
        y0 = H // 2 - patch // 2
        x0 = W // 2 - patch // 2
        center = full[y0 : y0 + patch, x0 : x0 + patch]
        mid = patches["mid"].astype(np.float64)
        if kind == "depth":
            s, t = _lsq_scale_shift(center, mid)
            full = s * full + t
        else:
            R = _kabsch(center.reshape(-1, 3), mid.reshape(-1, 3))
            full = full @ R.T
            full /= np.maximum(np.linalg.norm(full, axis=-1, keepdims=True), 1e-15)
    return full


def stitch_scene_cues(
    patch_dir: str,
    out_dir: str,
    n_frames: int,
    out_hw: tuple = (1152, 2048),
    patch: int = 360,
    stride: int = 120,
    device=None,
):
    """Read per-patch cue predictions ``%06d_%02d_%02d_{depth,normal}.npy``
    (+ ``%06d_mid_*``), stitch, resize to out_hw, save EST-layout cues."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    for f in range(n_frames):
        for kind in ("depth", "normal"):
            patches = {}
            for p in glob(os.path.join(patch_dir, f"{f:06d}_*_{kind}.npy")):
                stem = os.path.basename(p)[:-len(f"_{kind}.npy")]
                suffix = stem[len(f"{f:06d}_"):]
                arr = np.load(p)
                if kind == "normal" and arr.ndim == 3 and arr.shape[0] == 3:
                    arr = arr.transpose(1, 2, 0)
                if suffix == "mid":
                    patches["mid"] = arr
                else:
                    j, i = map(int, suffix.split("_"))
                    patches[(j, i)] = arr
            if not patches:
                continue
            full = merge_patches(patches, kind, patch, stride)
            full = resize(full, out_hw, "linear", device=dev)
            if kind == "depth":
                np.save(os.path.join(out_dir, f"{f:06d}_depth.npy"), full)
            else:
                norm = np.linalg.norm(full, axis=-1, keepdims=True)
                full = full / np.maximum(norm, 1e-15)
                np.save(
                    os.path.join(out_dir, f"{f:06d}_normal.npy"),
                    full.transpose(2, 0, 1),
                )

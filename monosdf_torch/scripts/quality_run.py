"""Quality evidence run of the port (scripts/quality_run.py's counterpart,
with its flags and its results schema): train a shipped conf on a
synthetic scene end to end through the port's CLIs, then measure the mesh
against the analytic ground truth.

Pipeline (the reference's own train->extract->eval loop,
monosdf_train.py + evaluation/eval.py + replica_eval/eval_recon.py):
  1. generate the on-disk scene with monosdf_torch/scripts/
     make_synthetic_scene.py if it is missing
  2. ``cli.train --conf`` (on the card unless --cpu)
  3. ``cli.eval --conf --checkpoint_dir`` -> surface_<res>.ply + psnr.csv
  4. Chamfer-L1 / F-score / normal consistency vs the ANALYTIC surface
  5. write results<_tag>.json (and a copy of the mesh) into --out_dir,
     docs/quality_torch/ by default; the JAX package's docs/quality/ holds
     its own runs

    python -m monosdf_torch.scripts.quality_run [--iters 20000] [--root exps/quality]
        [--res 96 --views 12] [--mesh_res 128] [--cpu] [--skip_train]
        [--conf confs/synth_union_quality.conf --shape union --tag union]

A run longer than one sitting trains in pieces through ``cli/train.py
--conf CONF --data_root ROOT/data --exps_root ROOT/exps --timestamp quality
--max_iters N [--resume]``, then ``quality_run --skip_train`` evaluates it
(the curve keeps the last pass that starts at iter 1, so a resumed log
keeps its whole curve). The results carry ``device``: nvidia-smi's card
name and power limit (``cpu`` with --cpu).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GT_RADIUS = 0.5


def fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    """Near-uniform points on a sphere (golden-angle spiral)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return (radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        -1,
    )).astype(np.float32)


# sphere+torus union constants — mirror scripts/make_synthetic_scene.py
_U_SPH_C = np.array([-0.36, 0.05, 0.0])
_U_SPH_R = 0.25
_U_TOR_C = np.array([0.34, -0.02, 0.0])
_U_TOR_R, _U_TOR_r = 0.24, 0.1


def union_surface(n: int, seed: int = 0):
    """GT surface points AND normals of the sphere+torus union (points
    inside the other solid rejected)."""
    rng = np.random.default_rng(seed)

    def sdf(p):
        ds = np.linalg.norm(p - _U_SPH_C, axis=-1) - _U_SPH_R
        q = p - _U_TOR_C
        rho = np.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
        dt = np.sqrt((rho - _U_TOR_R) ** 2 + q[..., 2] ** 2) - _U_TOR_r
        return np.minimum(ds, dt)

    pts, nrm = [], []
    while sum(len(p) for p in pts) < n:
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        ps, ns = _U_SPH_C + _U_SPH_R * v, v
        theta = rng.uniform(0, 2 * np.pi, n)
        phi = rng.uniform(0, 2 * np.pi, n)
        rho = _U_TOR_R + _U_TOR_r * np.cos(theta)
        pt = _U_TOR_C + np.stack(
            [rho * np.cos(phi), rho * np.sin(phi), _U_TOR_r * np.sin(theta)],
            -1,
        )
        nt = np.stack(
            [np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
             np.sin(theta)], -1,
        )
        cand = np.concatenate([ps, pt], axis=0)
        cn = np.concatenate([ns, nt], axis=0)
        keep = sdf(cand) > -1e-4
        pts.append(cand[keep])
        nrm.append(cn[keep])
    p = np.concatenate(pts, axis=0)
    g = np.concatenate(nrm, axis=0)
    # interleave components before truncation — a plain [:n] would keep
    # only the first (sphere) block of the concatenated candidates
    perm = rng.permutation(len(p))[:n]
    return p[perm].astype(np.float32), g[perm].astype(np.float32)


_ROOM_HALF = 0.55  # mirror scripts/make_synthetic_scene.py --room_half
_TOR_R, _TOR_r = 0.4, 0.15  # mirror --torus_R/--torus_r defaults (axis = y)


def torus_surface(n: int, seed: int = 0):
    """GT surface points AND normals of the genus-1 torus
    (make_synthetic_scene.py torus_sdf: rho in the xz plane)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)  # tube angle
    phi = rng.uniform(0, 2 * np.pi, n)  # around the axis
    rho = _TOR_R + _TOR_r * np.cos(theta)
    pts = np.stack(
        [rho * np.cos(phi), _TOR_r * np.sin(theta), rho * np.sin(phi)], -1
    ).astype(np.float32)
    nrm = np.stack(
        [np.cos(theta) * np.cos(phi), np.sin(theta),
         np.cos(theta) * np.sin(phi)], -1
    ).astype(np.float32)
    return pts, nrm


def room_surface(n: int, half: float = _ROOM_HALF, seed: int = 0):
    """GT surface points AND inward normals of the box room's interior
    walls (the only surface an indoor reconstruction can see)."""
    rng = np.random.default_rng(seed)
    face_axis = rng.integers(0, 3, size=n)
    face_sign = rng.choice([-1.0, 1.0], size=n)
    uv = rng.uniform(-half, half, size=(n, 2))
    pts = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    for ax in range(3):
        sel = face_axis == ax
        others = [a for a in range(3) if a != ax]
        pts[sel, ax] = face_sign[sel] * half
        pts[sel, others[0]] = uv[sel, 0]
        pts[sel, others[1]] = uv[sel, 1]
        nrm[sel, ax] = -face_sign[sel]
    return pts, nrm


def card_name(cpu: bool) -> str:
    """nvidia-smi's card name and power limit (``cpu`` for a CPU run)."""
    if cpu:
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def last_pass(rows: list) -> list:
    """The rows of a metrics log's last pass: a re-run log can hold
    several, each starting at iter 1; a resumed one continues its pass."""
    starts = [i for i, r in enumerate(rows) if r["iter"] == 1]
    return rows[starts[-1]:] if starts else rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join("exps", "quality"),
                    help="the scene, run and eval directories (default: exps/quality under "
                         "the working directory; the JAX script's default is /tmp/quality)")
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--mesh_res", type=int, default=128)
    ap.add_argument("--cpu", action="store_true", help="run the CLIs with --device cpu")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--conf", default=os.path.join(REPO, "confs/synth_sphere_quality.conf"))
    ap.add_argument("--conf_add", default=None)
    ap.add_argument("--expname", default=None,
                    help="train.expname of --conf (names the run dir; default: the conf's)")
    ap.add_argument("--tag", default="",
                    help="artifact suffix (e.g. 'grids' -> results_grids.json)")
    ap.add_argument("--hdr", action="store_true",
                    help="generate the scene in linear HDR (EXR images, "
                    "union shape; pair with confs/synth_union_hdr.conf)")
    ap.add_argument("--shape", default="sphere",
                    choices=("sphere", "union", "room", "torus"),
                    help="GT geometry: analytic sphere, the textured "
                    "sphere+torus union scene, the indoor EST-cue box room, "
                    "or the genus-1 torus")
    ap.add_argument("--gt_samples", type=int, default=200_000,
                    help="surface samples of the mesh and of the ground truth (the protocol's "
                    "200k; fewer for a quick check of the pipeline)")
    ap.add_argument("--out_dir", default=os.path.join(REPO, "docs", "quality_torch"),
                    help="where results<_tag>.json and the mesh copy go")
    args = ap.parse_args(argv)

    from ..cli.eval import main as eval_main
    from ..cli.train import main as train_main
    from ..config import build_configs, load_conf
    from ..eval.metrics import (
        chamfer_distance, f_score, normal_consistency, sample_mesh_surface,
    )
    from ..meshing import read_ply
    from . import make_synthetic_scene

    device = ["--device", "cpu"] if args.cpu else []
    conf_add = ["--conf_add", args.conf_add] if args.conf_add else []
    expname = args.expname or build_configs(load_conf(args.conf, args.conf_add)).expname
    data_root = os.path.join(args.root, "data")
    exps_root = os.path.join(args.root, "exps")
    eval_dir = os.path.join(args.root, "eval")
    scene_dir = os.path.join(data_root, f"{args.shape}_scene")

    if not os.path.isdir(scene_dir):
        gen = [data_root, "--n", str(args.views), "--res", str(args.res)]
        if args.shape in ("union", "room", "torus"):
            gen += ["--shape", args.shape]
        else:
            gen += ["--radius", str(GT_RADIUS)]
        if args.hdr:
            gen += ["--hdr"]
        make_synthetic_scene.main(gen)

    run_dir = os.path.join(exps_root, f"quality-{expname}")
    t_train = 0.0
    if not args.skip_train:
        t0 = time.time()
        train_main([
            "--conf", args.conf, "--data_root", data_root,
            "--exps_root", exps_root, "--n_devices", "1",
            "--timestamp", "quality", "--max_iters", str(args.iters),
        ] + conf_add + device)
        t_train = time.time() - t0

    eval_main([
        "--conf", args.conf, "--data_root", data_root,
        "--checkpoint_dir", os.path.join(run_dir, "checkpoints"),
        "--resolution", str(args.mesh_res), "--eval_rendering",
        "--out_dir", eval_dir,
    ] + conf_add + device)

    # ---- mesh quality vs the analytic surface ----
    mesh_path = os.path.join(eval_dir, f"surface_{args.mesh_res}.ply")
    verts, faces = read_ply(mesh_path)
    pp, pn = sample_mesh_surface(np.asarray(verts), np.asarray(faces), args.gt_samples)
    if args.shape == "union":
        pg, gn = union_surface(args.gt_samples)
        radius_err = None  # no single-radius notion for the union (JSON null)
    elif args.shape == "room":
        pg, gn = room_surface(args.gt_samples)
        radius_err = None
    elif args.shape == "torus":
        pg, gn = torus_surface(args.gt_samples)
        radius_err = None
    else:
        pg = fibonacci_sphere(args.gt_samples, GT_RADIUS)
        gn = pg / GT_RADIUS
        radius_err = float(
            np.abs(np.linalg.norm(pp, axis=-1) - GT_RADIUS).mean()
        )
    acc, comp, chamfer = chamfer_distance(pp, pg)
    prec, rec, fs = f_score(pp, pg, threshold=0.05)
    nc = normal_consistency(pp, pn, pg, gn)

    # ---- curves from metrics.jsonl ----
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = last_pass([json.loads(line) for line in f])
    want = {1, 100, 250, 500, 1000, 2000, 5000, 10000, 15000, args.iters}
    curve = [r for r in rows if r["iter"] in want]

    psnr_rows = []
    with open(os.path.join(eval_dir, "psnr.csv")) as f:
        next(f)
        for line in f:
            frame, p = line.strip().split(",")
            psnr_rows.append((frame, float(p)))
    eval_psnr = dict(psnr_rows).get("mean", float("nan"))

    results = {
        "iters": args.iters,
        "train_wall_s": round(t_train, 1),
        "final_train_loss": rows[-1]["loss"],
        "final_train_psnr": rows[-1]["psnr"],
        "eval_psnr_mean": eval_psnr,
        "chamfer_l1": chamfer,
        "accuracy": acc,
        "completion": comp,
        "precision@5cm": prec,
        "recall@5cm": rec,
        "f_score@5cm": fs,
        "normal_consistency": nc,
        "mean_radius_error": radius_err,
        "mesh_verts": int(len(verts)),
        "mesh_faces": int(len(faces)),
    }
    if args.shape == "torus":
        from ..meshing.alt_extract import mesh_topology

        topo = mesh_topology(np.asarray(verts), np.asarray(faces))
        results["genus"] = topo.get("genus")
        results["watertight"] = topo.get("watertight")
    results["device"] = card_name(args.cpu)
    print(json.dumps(results, indent=2))

    # ---- artifacts ----
    os.makedirs(args.out_dir, exist_ok=True)
    suffix = f"_{args.tag}" if args.tag else ""
    shutil.copy(
        mesh_path,
        os.path.join(args.out_dir, f"{args.shape}{suffix}_surface_{args.mesh_res}.ply"),
    )
    with open(os.path.join(args.out_dir, f"results{suffix}.json"), "w") as f:
        json.dump({"results": results, "curve": curve}, f, indent=2)
    print(f"artifacts -> {args.out_dir}")
    return results, curve


if __name__ == "__main__":
    main()

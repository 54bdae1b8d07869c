"""Batch mesh extraction from trained checkpoints
(scripts/extract_all_meshes.py of the JAX package).

Equivalent of the reference's
scripts/extract_all_meshes_from_pretrained_models.py: loop (conf, scan,
checkpoint) triples -> evaluation CLI -> world-space meshes at a chosen
resolution.

    python -m monosdf_torch.scripts.extract_all_meshes --exps_root exps \
        --data_root data --out_dir meshes [--resolution 512] [--device cuda]

Every run directory under exps_root with a checkpoints/latest.ckpt and a
runconf.conf gets a mesh, through ``python -m monosdf_torch.cli.eval --conf
... --checkpoint_dir ...`` (on the card unless ``--device cpu``). The
Trainer writes no runconf.conf (neither package's does): a run is selected
once its conf has been copied there.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from glob import glob



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exps_root", required=True)
    ap.add_argument("--data_root", default="data")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--world_space", action="store_true")
    ap.add_argument("--device", default=None, help="passed to cli/eval.py; default: cuda")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    runs = sorted(glob(os.path.join(args.exps_root, "*")))
    done = 0
    for run in runs:
        conf = os.path.join(run, "runconf.conf")
        ckpt_dir = os.path.join(run, "checkpoints")
        if not (os.path.exists(conf) and os.path.exists(
            os.path.join(ckpt_dir, "latest.ckpt")
        )):
            continue
        name = os.path.basename(run)
        out = os.path.join(args.out_dir, name)
        print(f"=== {name}", flush=True)
        cmd = [
            sys.executable, "-m", "monosdf_torch.cli.eval",
            "--conf", conf, "--checkpoint_dir", ckpt_dir,
            "--data_root", args.data_root,
            "--resolution", str(args.resolution), "--out_dir", out,
        ]
        if args.world_space:
            cmd.append("--world_space")
        if args.device is not None:
            cmd += ["--device", args.device]
        r = subprocess.run(cmd)
        done += r.returncode == 0
    print(f"extracted {done} meshes -> {args.out_dir}")
    return done


if __name__ == "__main__":
    main()

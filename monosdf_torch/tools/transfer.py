"""Experiment transfer: sync the latest checkpoint + conf + meshes of a run
to another machine (monosdf_tpu/tools/transfer.py; reference
code/tools/transfer_task.py, transfer_exps.py).

    python -m monosdf_torch.tools.transfer --run exps/<run> \
        --dest user@host:/path/exps [--all_plys] [--dry_run]

Uses rsync (falls back to scp); only the newest numbered checkpoint,
latest.ckpt, runconf + metrics, and the newest mesh are sent by default.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from glob import glob


def collect_files(run_dir: str, all_plys: bool = False):
    files = []
    ckpts = sorted(
        glob(os.path.join(run_dir, "checkpoints", "*.ckpt")), key=os.path.getmtime
    )
    files += ckpts[-2:]  # newest numbered + latest
    for pat in ("runconf.conf", "metrics.jsonl"):
        p = os.path.join(run_dir, pat)
        if os.path.exists(p):
            files.append(p)
    plys = sorted(glob(os.path.join(run_dir, "plots", "*.ply")), key=os.path.getmtime)
    files += plys if all_plys else plys[-1:]
    return files


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True)
    ap.add_argument("--dest", required=True)
    ap.add_argument("--all_plys", action="store_true")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    files = collect_files(args.run, args.all_plys)
    run_name = os.path.basename(os.path.normpath(args.run))
    cmds = []
    for f in files:
        rel = os.path.relpath(f, args.run)
        dest = f"{args.dest}/{run_name}/{rel}"
        cmd = ["rsync", "-a", "--mkpath", f, dest]
        print(" ".join(cmd))
        cmds.append(cmd)
        if not args.dry_run:
            try:
                subprocess.run(cmd, check=True)
            except FileNotFoundError:
                subprocess.run(["scp", f, dest], check=True)
    return cmds


if __name__ == "__main__":
    main()

"""Experiment-directory garbage collection (monosdf_tpu/tools/cleanup.py).

Reference: code/tools/clean_funcs.py — keep-last-N checkpoints per run
(:11-29), keep-last-N epochs of plots/meshes (:32-64), batch CLI over an
experiments root (:66-101).

    python -m monosdf_torch.tools.cleanup --exps_root exps \
        [--keep_ckpt 3] [--keep_plots 2] [--dry_run]
"""

from __future__ import annotations

import argparse
import os
import re
from glob import glob

_EPOCH_RE = re.compile(r"(\d+)")


def _numbered(paths):
    """[(epoch, path)] for files whose stem contains a number."""
    out = []
    for p in paths:
        m = _EPOCH_RE.findall(os.path.basename(p))
        if m:
            out.append((int(m[-1]), p))
    return sorted(out)


def gc_checkpoints(ckpt_dir: str, keep_last: int = 3, dry_run: bool = False):
    """Remove all but the newest keep_last numbered *.ckpt (latest.ckpt is
    always kept)."""
    removed = []
    numbered = _numbered(
        p for p in glob(os.path.join(ckpt_dir, "*.ckpt"))
        if not p.endswith("latest.ckpt")
    )
    for _, p in numbered[:-keep_last] if keep_last > 0 else numbered:
        removed.append(p)
        if not dry_run:
            os.remove(p)
    return removed


def gc_plots(plot_dir: str, keep_last: int = 2, dry_run: bool = False):
    """Keep only the newest keep_last epochs of .ply/.png artifacts (the
    TensorBoard logs/ dir is untouched)."""
    removed = []
    by_epoch: dict[int, list] = {}
    for p in glob(os.path.join(plot_dir, "*.ply")) + glob(
        os.path.join(plot_dir, "*.png")
    ):
        m = _EPOCH_RE.findall(os.path.basename(p))
        if m:
            by_epoch.setdefault(int(m[0]), []).append(p)
    for ep in sorted(by_epoch)[:-keep_last] if keep_last > 0 else sorted(by_epoch):
        for p in by_epoch[ep]:
            removed.append(p)
            if not dry_run:
                os.remove(p)
    return removed


def gc_experiments(
    exps_root: str, keep_ckpt: int = 3, keep_plots: int = 2, dry_run: bool = False
):
    """GC every run under exps_root; returns {run: [removed paths]}."""
    report = {}
    for run in sorted(os.listdir(exps_root)):
        run_dir = os.path.join(exps_root, run)
        if not os.path.isdir(run_dir):
            continue
        removed = []
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        if os.path.isdir(ckpt_dir):
            removed += gc_checkpoints(ckpt_dir, keep_ckpt, dry_run)
        plot_dir = os.path.join(run_dir, "plots")
        if os.path.isdir(plot_dir):
            removed += gc_plots(plot_dir, keep_plots, dry_run)
        if removed:
            report[run] = removed
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exps_root", required=True)
    ap.add_argument("--keep_ckpt", type=int, default=3)
    ap.add_argument("--keep_plots", type=int, default=2)
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)
    report = gc_experiments(
        args.exps_root, args.keep_ckpt, args.keep_plots, args.dry_run
    )
    for run, removed in report.items():
        tag = "would remove" if args.dry_run else "removed"
        print(f"{run}: {tag} {len(removed)} files")
    return report


if __name__ == "__main__":
    main()

"""The first epochs of a conf from several initial states: for each seed
(the Trainer's initialisation and draws), and from another run's checkpoint
with ``--load_from`` (the seed then sets the draws only), train epoch by
epoch through ``train.trainer.Trainer`` and after each epoch mesh the SDF at
the conf's plot resolution and take its least value on a ``--grid``^3
lattice over the mesh box. A start whose SDF has no negative value has no
surface to mesh. Prints one JSON line a start and writes them to ``--out``.

    python -m monosdf_torch.scripts.seed_study --conf confs/synth_union_hdr.conf \
        --data_root ROOT --exps_root EXPS --seeds 0 1 2 --iters 2000 --out seeds.json
    python -m monosdf_torch.scripts.seed_study --conf confs/synth_union_hdr.conf \
        --data_root ROOT --exps_root DIR --load_from init --seeds 0 --iters 2000

The scene is ``<data_root>/<dataset.data_dir>`` (e.g. from
``scripts/make_synthetic_scene.py ROOT --shape union --hdr --n 12 --res
96``); ``--load_from init`` reads ``DIR/init-<expname>/checkpoints``
(``tests/conf_sdf_trajectory.py --save_init DIR`` writes the JAX package's
initial state there). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def least_sdf(model, exp, n: int) -> float:
    """The SDF's least value on an n^3 lattice over the mesh box."""
    from ..meshing import mesh_sdf_fn

    lo, hi = exp.grid_boundary
    dev = next(model.parameters()).device
    axis = torch.linspace(lo, hi, n, device=dev)
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    with torch.no_grad():
        return float(mesh_sdf_fn(model, exp.model)(pts).min())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf", required=True)
    ap.add_argument("--conf_add", default=None)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--exps_root", default="exps")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--load_from", default=None,
                    help="start from this run's checkpoint (Trainer load_from) instead")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--grid", type=int, default=65)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out", default=None, help="a JSON file for the results")
    args = ap.parse_args(argv)

    from ..cli.common import dataset_config_from_conf
    from ..config import build_configs, load_conf
    from ..data.scene_dataset import SceneDataset
    from ..device import resolve_device
    from ..train.trainer import Trainer

    device = resolve_device(args.device)
    exp = build_configs(load_conf(args.conf, args.conf_add))
    ds = SceneDataset(dataset_config_from_conf(exp.dataset, args.data_root, "", "train"))
    rays = ds.pixel_rays()
    out = []
    for seed in args.seeds:
        start = f"{args.load_from}-draws{seed}" if args.load_from else f"seed{seed}"
        trainer = Trainer(exp, rays, exps_root=args.exps_root, timestamp=start, seed=seed,
                          load_from=args.load_from, scale=ds.scale, center=ds.center,
                          device=device)
        ipe = trainer.iters_per_epoch
        epochs = []
        while trainer.step < args.iters:
            trainer.train(max_iters=min(args.iters, (trainer.step // ipe + 1) * ipe))
            _, verts, _ = trainer.export_mesh(
                path=os.path.join(trainer.plot_dir, f"surface_{trainer.step}.ply"))
            epochs.append({"iter": trainer.step, "verts": int(len(verts)),
                           "sdf_min": least_sdf(trainer.model, exp, args.grid)})
            print(f"{start}: step {trainer.step} vertices {epochs[-1]['verts']} least SDF "
                  f"{epochs[-1]['sdf_min']:.5f}", flush=True)
        trainer.close()
        with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        rec = {"start": start, "conf": args.conf, "iters": trainer.step, "grid": args.grid,
               "epochs": epochs,
               "curve": [{k: r[k] for k in ("iter", "loss", "psnr", "beta")} for r in rows]}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del trainer
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

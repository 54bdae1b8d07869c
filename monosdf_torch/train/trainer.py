"""Training orchestration: the MonoSDFTrainRunner equivalent
(monosdf_tpu/train/trainer.py ``Trainer``).

Reference: code/training/monosdf_train.py (MonoSDFTrainRunner.__init__/run,
:34-485). As in the JAX package:

* the data path is host-numpy pixel gather (``np.random.default_rng(seed)``:
  the JAX trainer's draws with process index 0) and one training step per
  batch (``train.step.make_train_step``), no DataLoader workers;
* the run directory is ``<exps_root>/<timestamp>-<prefix><expname><suffix>``
  with ``checkpoints/``, ``plots/``, ``metrics.jsonl`` and ``plots/logs``;
  resume finds the newest run of the name, ``load_from`` warm-starts from
  another run's latest checkpoint, found by prefix;
* checkpoints (``train.checkpoint``, the JAX package's payload) every
  ``checkpoint_freq`` epochs and at the end, validation plots (the mesh,
  then the dashboards) every ``plot_freq`` epochs, a divergence guard that
  writes ``-1.ckpt`` and raises ``FloatingPointError``;
* ``steps_per_call`` is accepted; the steps run one by one, so the log and
  the checkpoints see the iteration counts of JAX's scan path.

The sampler's and the eikonal draws come from a ``torch.Generator`` on the
model's device, seeded with ``seed``. The model runs on ``cuda`` unless
``device='cpu'``.

Data parallelism (``parallel``, the JAX trainer's ``n_devices > 1``
branch): inside a process group (``parallel.init_group``; ``cli/train.py
--n_devices N`` or ``--multihost`` makes one) the model runs under DDP on
the rank's device. Every rank draws the global batch of ``num_pixels * W``
rays from ``np.random.default_rng(seed)`` and keeps its contiguous rows
(``parallel.shard_batch``), so the global batches are the JAX trainer's;
each rank draws its samples from its own generator
(``parallel.rank_generator``, rank 0's the single-device stream). The log's
metrics are the mean over ranks and ``rays_per_sec`` counts the global
batch; the divergence guard reads the mean loss, so every rank stops
together. Only rank 0 writes the checkpoints, plots, meshes, TensorBoard
and ``metrics.jsonl``, and the ranks wait for it after each; resume and
``load_from`` restore every rank (DDP broadcasts parameters, not Adam's
moments). One step per call, as the JAX trainer's sharded path.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import numpy as np
import torch

from ..cli.eval import frame_psnr, render_image
from ..device import resolve_device
from ..meshing import extract_mesh, mesh_sdf_fn, write_ply
from ..models.monosdf import init_monosdf
from ..parallel.ddp import (barrier, broadcast_object, in_group, make_parallel_train_step,
                            rank_generator, replicas_agree, replicate, shard_batch, world)
from ..viz import MetricsWriter, get_plot_data, plot
from .checkpoint import load_checkpoint, restore_state, save_checkpoint
from .optim import make_optimizer
from .step import make_train_step


class Trainer:
    def __init__(
        self,
        exp,
        train_rays: dict,
        val_images=None,          # list of dataset.image_rays(i) dicts
        exps_root: str = "exps",
        expname_suffix: str = "",
        expname_prefix: str = "",
        resume: bool = False,
        load_from: str | None = None,
        timestamp: str | None = None,
        seed: int = 0,
        n_devices: int = 1,
        scale: float | None = None,
        center=None,
        steps_per_call: int = 1,
        device=None,
    ):
        self.rank, self.world = world()
        self.distributed = in_group()
        if n_devices > 1 and n_devices != self.world:
            raise ValueError(f"n_devices={n_devices} needs a process group of {n_devices} ranks "
                             f"(parallel.init_group; cli/train.py --n_devices spawns one), "
                             f"not {self.world}")
        self.exp = exp
        self.train_rays = train_rays
        self.val_images = val_images or []
        self.scale, self.center = scale, center
        self.device = resolve_device(device)

        # experiment dir layout (reference monosdf_train.py:104-138);
        # prefix/suffix mirror exp_runner.py --prefix/--append + scan_id
        name = expname_prefix + exp.expname + expname_suffix
        if resume:
            timestamp = timestamp or self._find_latest_run(exps_root, name)
        timestamp = timestamp or datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        timestamp = broadcast_object(timestamp)  # one run directory for every rank
        self.run_dir = os.path.join(exps_root, f"{timestamp}-{name}")
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.plot_dir = os.path.join(self.run_dir, "plots")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.plot_dir, exist_ok=True)

        self.rng = np.random.default_rng(seed)
        self.generator = rank_generator(seed, self.rank, self.device)
        self.model = init_monosdf(exp.model, seed=seed, device=self.device)
        self.optimizer = make_optimizer(exp.optim, self.model.named_parameters())
        self.ddp_model = None
        if self.distributed:
            self.step_fn = make_parallel_train_step(exp.model, exp.loss, self.optimizer)
        else:
            self.step_fn = make_train_step(exp.model, exp.loss, self.optimizer)
        self.steps_per_call = 1 if self.distributed else max(1, int(steps_per_call))

        self.start_epoch = 0
        if resume and os.path.exists(os.path.join(self.ckpt_dir, "latest.ckpt")):
            payload = load_checkpoint(self.ckpt_dir)
            restore_state(self.model, self.optimizer, payload)
            self.start_epoch = payload["epoch"]
            print(f"resumed from step {payload['step']} (epoch {payload['epoch']})")
        elif load_from:
            # warm-start THIS run from another experiment's latest checkpoint,
            # found by run-dir prefix (reference exp_runner.py --load_from +
            # monosdf_train.py:70-84); ambiguity resolves to the newest run
            def _matches(d):
                name_part = d.split("-", 2)[-1]
                return d.startswith(load_from) or name_part.startswith(load_from)

            cands = sorted(
                d for d in os.listdir(exps_root)
                if _matches(d)
                and os.path.exists(os.path.join(exps_root, d, "checkpoints", "latest.ckpt"))
            )
            if not cands:
                raise FileNotFoundError(
                    f"--load_from: no run matching prefix {load_from!r} with a "
                    f"checkpoint under {exps_root}"
                )
            payload = load_checkpoint(os.path.join(exps_root, cands[-1], "checkpoints"))
            restore_state(self.model, self.optimizer, payload)
            self.start_epoch = payload["epoch"]
            print(f"loaded from {cands[-1]} (step {payload['step']}, epoch {payload['epoch']})")
        if self.distributed:
            # after the restore: every rank holds the same parameters and moments
            self.ddp_model = replicate(self.model)

        self.iters_per_epoch = max(1, train_rays["rays_o"].shape[0] // exp.num_pixels)
        self.metrics_log = None
        if self.rank == 0:
            self.metrics_log = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        # rank 0's TensorBoard under plots/logs (reference monosdf_train.py:303-304)
        self.writer = MetricsWriter(os.path.join(self.plot_dir, "logs"), enabled=self.rank == 0)
        self._gt_plotted = False

    @staticmethod
    def _find_latest_run(exps_root: str, name: str):
        """Resume-by-prefix lookup (reference monosdf_train.py:69-84)."""
        if not os.path.isdir(exps_root):
            return None
        runs = sorted(d for d in os.listdir(exps_root) if d.endswith(f"-{name}"))
        return runs[-1].split("-" + name)[0] if runs else None

    def close(self):
        """Close the metrics log and the writer."""
        if self.metrics_log is not None:
            self.metrics_log.close()
        self.writer.close()

    @property
    def step(self) -> int:
        """Training steps taken (the schedule's count)."""
        return int(self.optimizer.schedule.last_epoch)

    # ------------------------------------------------------------------
    def sample_batch(self, num_rays: int) -> dict:
        """Pixel mode (fork default): global random rays across every frame.
        Image mode (if_pixel=False, the upstream default): all rays of one
        randomly-chosen frame per step (reference scene_dataset.py:374-436).
        On the model's device; ``indices`` (int64) with per-image codes.
        Under a group of W ranks ``num_rays`` is the global batch's, and the
        rank gathers its contiguous num_rays / W of them."""
        tr = self.train_rays
        if self.exp.dataset.get("if_pixel", True):
            idx = self.rng.integers(0, tr["rays_o"].shape[0], size=(num_rays,))
        else:
            HW = tr["img_res"][0] * tr["img_res"][1]
            n_frames = tr["rays_o"].shape[0] // HW
            f = int(self.rng.integers(0, n_frames))
            idx = f * HW + self.rng.permutation(HW)[:num_rays]
        idx = shard_batch(idx, self.rank, self.world)
        on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        batch = {
            "rays": {k: on_dev(tr[k][idx]) for k in ("rays_o", "rays_d", "depth_scale", "pose")},
            "gt": {k: on_dev(tr[k][idx]) for k in ("rgb", "depth", "normal", "mask")},
        }
        if self.exp.model.rendering.per_image_code:
            batch["indices"] = on_dev(tr["indices"][idx].astype(np.int64))
        return batch

    def train(self, max_iters: int | None = None, log_every: int = 50):
        exp = self.exp
        max_iters = max_iters or exp.max_total_iters
        num_rays = exp.num_pixels * self.world

        it0 = self.step
        t_last = time.perf_counter()
        S = self.steps_per_call
        it = it0
        while it < max_iters:
            # a chunk of S steps, the tail one by one, as the JAX scan path
            s_chunk = S if (max_iters - it) >= S else 1
            log_now = ((it + s_chunk) // log_every) > (it // log_every) or it == it0
            for _ in range(s_chunk):
                if self.ddp_model is None:
                    metrics = self.step_fn(self.model, self.sample_batch(num_rays),
                                           generator=self.generator)
                else:
                    # the mean over ranks only where the log reads it
                    metrics = self.step_fn(self.ddp_model, self.sample_batch(num_rays),
                                           generator=self.generator, reduce_metrics=log_now)
            prev_it, it = it, it + s_chunk

            if log_now:
                metrics = {k: float(v) for k, v in metrics.items()}
                # failure detection: halt on divergence with a crash snapshot
                if not np.isfinite(metrics.get("loss", 0.0)):
                    print(f"[!] non-finite loss at iter {it}; saving crash "
                          "checkpoint and stopping")
                    self.save(-1)
                    raise FloatingPointError(f"loss diverged at iter {it}: {metrics}")
                dt = time.perf_counter() - t_last
                base_it = getattr(self, "_last_log_it", it0)
                rays_s = num_rays * max(1, it - base_it) / dt
                self._last_log_it = it
                t_last = time.perf_counter()
                rec = {"iter": it, "rays_per_sec": round(rays_s, 1), **metrics}
                if self.rank == 0:
                    print(
                        f"[{it}/{max_iters}] loss={metrics.get('loss', 0):.4f} "
                        f"psnr={metrics.get('psnr', 0):.2f} beta={metrics.get('beta', 0):.4f} "
                        f"({rays_s:,.0f} rays/s)"
                    )
                    self.metrics_log.write(json.dumps(rec) + "\n")
                    self.metrics_log.flush()
                tb = dict(metrics)
                if tb.get("beta"):
                    tb["alpha"] = 1.0 / tb["beta"]
                tb["rays_per_sec"] = rays_s
                self.writer.scalars(tb, it, prefix="train/")

            ckpt_period = self.iters_per_epoch * exp.checkpoint_freq
            epoch = it // self.iters_per_epoch
            if (it // ckpt_period) > (prev_it // ckpt_period):
                self.save(epoch)
            plot_period = self.iters_per_epoch * (exp.plot_freq or 0)
            if (
                exp.plot_freq
                and (it // plot_period) > (prev_it // plot_period)
                and it < max_iters
            ):
                self.plot_validation(epoch)
        self.save(max_iters // self.iters_per_epoch)
        if self.distributed:
            # the same update on every rank keeps the replicas equal, bit for bit
            if not replicas_agree(self.model):
                raise RuntimeError(f"the {self.world} ranks' parameters differ after {it} steps")
            if self.rank == 0:
                print(f"replicas: the {self.world} ranks hold the same parameters")
        return self.model

    def plot_validation(self, epoch: int, max_images: int = 1):
        """Reference run() VAL block (monosdf_train.py:318-389): mesh export
        + rendered val dashboards (PNG, and TensorBoard where it imports), on
        rank 0 while the other ranks wait."""
        if self.rank != 0:
            barrier()
            return
        try:
            self.export_mesh(path=os.path.join(self.plot_dir, f"surface_{epoch}.ply"))
        except Exception as e:
            print(f"mesh export failed: {e}")
        for image in self.val_images[:max_images]:
            out = self.render_image(image)
            data = get_plot_data(out, image, image["img_res"])
            plot(
                data,
                self.plot_dir,
                epoch,
                image["img_res"],
                frame_idx=image["frame_idx"],
                prefix="VAL_",
                if_hdr=self.exp.model.rendering.if_hdr,
                writer=self.writer,
                tid=self.step,
                plot_gt=not self._gt_plotted,
            )
        self._gt_plotted = True
        self.writer.flush()
        barrier()

    def save(self, epoch: int):
        """The checkpoint of ``epoch``, written by rank 0 while the other ranks wait."""
        if self.rank == 0:
            save_checkpoint(self.ckpt_dir, self.model, self.optimizer, epoch)
        barrier()

    # ------------------------------------------------------------------
    def render_image(self, image: dict, chunk: int | None = None) -> dict:
        """Chunked full-image render (reference split_input/merge_output,
        monosdf_train.py:347-387) of a ``image_rays`` dict. Returns numpy
        maps {rgb, depth, normal}."""
        cfg = self.exp.model
        rays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in image["rays"].items()}
        code = None
        if cfg.rendering.per_image_code:
            code = self.model.rendering.embeddings.detach()[image["frame_idx"]]
        out = render_image(self.model, cfg, rays, chunk or self.exp.split_n_pixels, code)
        return {k: out[v].cpu().numpy() for k, v in
                (("rgb", "rgb_values"), ("depth", "depth_values"), ("normal", "normal_map"))}

    def validate(self, max_images: int = 1) -> list:
        """Render val views, compute PSNR (gamma'd when HDR, reference
        eval.py:124-139)."""
        return [{"frame_idx": image["frame_idx"],
                 "psnr": frame_psnr(self.exp.model, self.render_image(image)["rgb"],
                                    image["gt"]["rgb"])}
                for image in self.val_images[:max_images]]

    def export_mesh(self, path: str | None = None, resolution: int | None = None,
                    world_space: bool = False):
        """The SDF's zero set at ``resolution`` (the conf's plot resolution)
        over ``grid_boundary`` through ``meshing.mesh_sdf_fn`` (K1, and K6
        in grid mode, on the card), written as a PLY."""
        verts, faces = extract_mesh(
            mesh_sdf_fn(self.model, self.exp.model),
            resolution=resolution or self.exp.plot_resolution,
            grid_boundary=self.exp.grid_boundary,
            scale=self.scale if world_space else None,
            center=self.center if world_space else None,
        )
        path = path or os.path.join(self.plot_dir, f"surface_{self.step}.ply")
        write_ply(path, verts, faces)
        return path, verts, faces

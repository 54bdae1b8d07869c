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
``device='cpu'``; more than one device raises (data parallelism is not
ported yet).
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
        if n_devices > 1:
            raise NotImplementedError("more than one device: data parallelism is not ported yet")
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
        self.run_dir = os.path.join(exps_root, f"{timestamp}-{name}")
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.plot_dir = os.path.join(self.run_dir, "plots")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.plot_dir, exist_ok=True)

        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = init_monosdf(exp.model, seed=seed, device=self.device)
        self.optimizer = make_optimizer(exp.optim, self.model.named_parameters())
        self.step_fn = make_train_step(exp.model, exp.loss, self.optimizer)
        self.steps_per_call = max(1, int(steps_per_call))

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

        self.iters_per_epoch = max(1, train_rays["rays_o"].shape[0] // exp.num_pixels)
        self.metrics_log = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        # TensorBoard under plots/logs (reference monosdf_train.py:303-304)
        self.writer = MetricsWriter(os.path.join(self.plot_dir, "logs"))
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
        On the model's device; ``indices`` (int64) with per-image codes."""
        tr = self.train_rays
        if self.exp.dataset.get("if_pixel", True):
            idx = self.rng.integers(0, tr["rays_o"].shape[0], size=(num_rays,))
        else:
            HW = tr["img_res"][0] * tr["img_res"][1]
            n_frames = tr["rays_o"].shape[0] // HW
            f = int(self.rng.integers(0, n_frames))
            idx = f * HW + self.rng.permutation(HW)[:num_rays]
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
        num_rays = exp.num_pixels

        it0 = self.step
        t_last = time.perf_counter()
        S = self.steps_per_call
        it = it0
        while it < max_iters:
            # a chunk of S steps, the tail one by one, as the JAX scan path
            s_chunk = S if (max_iters - it) >= S else 1
            for _ in range(s_chunk):
                metrics = self.step_fn(self.model, self.sample_batch(num_rays),
                                       generator=self.generator)
            prev_it, it = it, it + s_chunk

            if (it // log_every) > (prev_it // log_every) or prev_it == it0:
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
        return self.model

    def plot_validation(self, epoch: int, max_images: int = 1):
        """Reference run() VAL block (monosdf_train.py:318-389): mesh export
        + rendered val dashboards (PNG, and TensorBoard where it imports)."""
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

    def save(self, epoch: int):
        save_checkpoint(self.ckpt_dir, self.model, self.optimizer, epoch)

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

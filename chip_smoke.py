"""Smoke run of the PyTorch/CUDA port (monosdf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels  # build and check the kernels only (probes included)
    python3 chip_smoke.py --witness 0,1 2,3  # the trained union model's float64 witness
                                             # statistics on those views, no gate
    python3 chip_smoke.py --ddp      # build, then the data-parallel phase only

Three models: the bench's ScanNet-MLP model (bench.py), also with its
sweeps through K1-PE (sweep_pe_in_kernel, scripts/bench_step.py --sweep_pe),
its hash-grid model (bench.py --grids) and the appearance-code model of
confs/synth_union_quality.conf (cli/eval.py union_codes_config: per-image
codes, white background, sphere sampler), the last with its radiance
through K3 and through K8a; all on the synthetic sphere, and the
appearance-code model also on a union scene that the port generates and
reads from disk; then three shipped confs (union, grid, HDR) through the
CLIs' --conf path. Phases (any failure exits non-zero):
1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels' nineteen libraries from monosdf_torch/csrc with nvcc
   for sm_90a, one nvcc per source, all at once (twenty kernels: K1-PE is
   K1's library on raw points, counted on its own); count the HGMMA
   (wgmma) instructions in the SASS of the tensor-core kernels' libraries,
   the bulk copies (UBLKCP) in R's and M's and the bulk stores
   (UBLKCP.G.S) in C's (cuobjdump), failing on none;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, and time kernel and plain version (CUDA events):
   the forwards at the shapes of one 1024-ray render chunk of the bench's
   ScanNet-MLP model (K1 and K1-PE at the sweep's 131,072 points, on the
   embedding and on the raw points), K2's training forward (clamp_rows,
   flag, saved Z) and
   K2b at the training step's 104,448 points, K3b at its 100,352 samples;
   K2f's bf16 render chunk kernel against its order reference, the SIMT
   kernel, bit for bit on the MLP and union models' trunks (and the
   reference's time); K4's speculative kernel against its order reference,
   the same kernel at depth 1, bit for bit, with K4's device time per
   launch (torch.profiler) and host time per call;
   for the grid model K6 at the sweeps' 131,072 points (6 levels) and at
   the step's 104,448 points (16 levels, with tangents), K5, K7f and K7b at
   104,448 points, K1 at the grid trunk's 71-wide input; K6 and K5 again
   at ray-ordered points (1024 rays through the box, as the model gives
   them: K6 held to its plain version there, wall, device and host times,
   bounds from those points' table sectors, K5's index_add_ yardstick and
   the device time of the memset that zeroes its gradient); the radiance
   kernels at the step's 100,352 samples: K3f/K3b with the union model's
   32-wide code, K8a forward and backward on its raw gradient, K8b forward
   and backward on the nerf trunk's 283-wide input (its bf16 backward run
   twice, bit for bit);
4. render 4 synthetic 64x64 views through cli/eval.py at full width
   (geometric init plus seeded noise) with the kernels, counting launches
   (K1 = K4 = 5 and K2 = K3 = 1 per chunk, K2f's and K4's order
   references 0 on every main path); render every chunk again with
   each kernel's plain version in its wrapper's place, once through the
   sampler and once at the kernel render's own samples (render_samples),
   and compare; time one chunk both ways; phases 4 and 5 again with
   sweep_pe_in_kernel (K1-PE = 5 and K1 = 0 per chunk and per step);
5. train: 3 warm-up and 20 timed steps of cli/train.py's step at full
   width in bf16 on distinct 1024-ray batches, counting launches (K1 = K4
   = 5, K2f = K3f = K2b = K3b = 1 per step), failing on a non-finite loss
   or gradient; then, at one batch with the samples and eikonal points
   fixed, the loss and every parameter gradient with the kernels and with
   each kernel's plain version in its place, compared, in bf16 and float32;
6. profile the render chunk and one training step (torch.profiler): device
   time per kernel, busy share (the union model's render chunk too);
7. the grid model: 4 views through cli/eval.py --grids (launches per
   chunk K1 = K4 = 4, K6 = 5, K7f = 1) with the like-for-like checks of
   phase 4; 3 warm-up and 20 timed steps of cli/train.py --grids (K1 = K4
   = 4, K6 = 5, K7f = K7b = K5 = 1 per step) and the step check of phase 5,
   the table's gradient included; a profile of a grid chunk and step;
8. the union model with per-image codes: 4 views through cli/eval.py
   --union (each frame with its own code; launches per chunk as the MLP
   model's) with the like-for-like checks of phase 4, 3 warm-up and 20
   timed steps of cli/train.py --union on batches over several frames and
   the step check of phase 5 (the embeddings' gradient included), and a
   profile of one step; then the same with --rgb_backend pallas (K8a in
   K3's place: K1 = K4 = 5, K2f = K8a = 1 per chunk, K2b = K8a's backward
   = 1 more per step, K3 0): a render, the steps, the step check, a
   profile of a chunk and of a step;
9. the scene: a union scene (4 views of 64x64, PNG frames and masks)
   written by the port's generator (monosdf_torch/scripts/
   make_synthetic_scene.py) into a temporary directory and loaded by
   data.SceneDataset (masks on); 3 warm-up and 20 timed steps of
   cli/train.py's step of the union-codes model on distinct 1024-ray
   batches of its pixel_rays (launches as phase 8's, losses and gradients
   finite), every view through cli/eval.py's evaluate from image_rays
   (each frame with its code, launches per chunk as phase 8's), each
   frame's PSNR; then the HDR scene (--hdr: EXR frames, the model's HDR
   output and gamma loss): 3 + 5 steps and one view, its PSNR through the
   sRGB gamma; generation, load, step and render times; fails where jax,
   monosdf_tpu, cv2 or PIL was imported;
10. the meshes (cli/eval.py's export: meshing.extract_mesh on
   meshing.mesh_sdf_fn, marched by the native marcher built from
   monosdf_torch/native): the union model phase 9 trained, at resolution
   512 over (-1.1, 1.1) in crops of 128 (the point pyramid; its SDF grid
   through K1 at float32, one launch a call of the SDF callable), and the
   grid model at 256 (K6 and K1, one launch each a call), launches counted
   from 0 (the order references 0); each extraction again with the plain
   versions (face counts within 0.1%, the symmetric mean nearest-vertex
   distance within 1e-2 of a cell), one dense crop's SDF grid at K1's
   float32 bar (and a grid off by that bar, marched, beyond the vertex
   bar), K1's float32 time on one chunk of 131,072 points; the PLY's
   write time and bytes; the union scene's analytic SDF meshed at 512 on
   the card, every vertex within 0.1 of a cell of its zero set, and the
   union model's Chamfer, F-score at 0.05 and normal consistency against
   it (20,000 samples a mesh; no bar); fails where jax, monosdf_tpu, cv2 or
   PIL was imported;
11. the conf path: confs/synth_union_quality.conf,
   synth_sphere_quality_grids.conf and synth_union_hdr.conf, each on a
   scene the port's generator writes at the confs' 96x96 (4 views), with an
   overlay that cuts only the run length (CONF_OVERLAY), through
   cli/train.py --conf (the Trainer: 20 steps of the union conf, then
   --resume to 30, crossing a checkpoint and a validation plot; 10 of the
   grid and HDR confs) and cli/eval.py --conf --checkpoint_dir
   --eval_rendering (the mesh at 512 and psnr.csv), on the card as the
   smoke's other phases (--device cuda:0); launches counted over
   those calls, every kernel config.routed_kernels names and no other;
   resume, checkpoint GC, metrics, plots, the grid conf's 1.0x encoding
   rate and the HDR conf's rgb_spec_values checked, and every closing and
   cli/eval.py mesh holding vertices (the HDR conf's where its SDF has a
   negative value); ms a step, in turns with the same
   step on batches sampled beforehand, the host batch alone, a profile of
   each kind of step, checkpoint write/read, plot and mesh times; the step
   check of phase 5 at the union and grid confs; fails where jax,
   monosdf_tpu, cv2, PIL or matplotlib was imported;
12. the quality run and the evaluation stack (the quality phase): the
   port's quality run (monosdf_torch/scripts/quality_run.py) on the sphere
   and union confs at full width on 12-view 96x96 scenes, 1000 and 900
   steps, meshes at 128 (QUALITY_RUNS), each held to its JAX CPU gate's
   bars (tests/test_quality_gate.py: the sphere's tail loss and PSNR
   relative to the JAX evidence curve at step 1000, vertices, mean radius
   error; the union's tail loss and PSNR, components, Chamfer), launches
   counted over each run; the trained union model against the plain
   versions on 2 of its scene's views (QUALITY_RENDER_VIEWS;
   trained_union_checks: each forward kernel on the inputs its render at
   the trained beta gives it at phase 3's bars; at the trained beta the
   kernel render and the plain render against the float64 witness
   (float64_witness: K2f and K3f, or K1, K4, K2f and K3f, replaced by
   float64 functions rounded where the kernels round), at the kernel
   render's samples and through the sampler, within WITNESS_F times the
   plain render's distance from it; the trained weights' renders at fixed
   samples at phase 8's bars with the density at phase 8's beta 0.1);
   cli/eval_mesh.py
   on the union mesh in the scannet (refuse: rasterizer and TSDF on the
   card), replica, dtu (mask cull) and generic flavors, scannet and dtu
   also with --device cpu, agreeing within the CPU tests' bars; the analytic
   sphere mesh rasterized from the sphere scene's 12 cameras within
   RASTER_BAR_CELLS of the ray-sphere depth; cli/render.py on the sphere
   mesh, 24 frames at 480x640 in each shading, one depth frame on the card
   against the CPU's; fails where a module of FOREIGN was imported;
13. the data pipeline (preprocess_phase): a raw ScanNet-layout scene at
   ScanNet's sizes (968x1296 colour, 480x640 depth, 11 frames of the
   generator's room), cli/preprocess.py scannet and cues (a TorchScript
   stand-in network) on the card and with --device cpu, cli/train.py --conf
   confs/scannet_mlp.conf (with the union conf's kernel routing) for 5
   steps, scripts/extract_all_meshes.py at 256 and the tools' dry runs;
   card against CPU and kernel mesh against the plain versions'; seconds
   per stage and per raw frame;
14. the nerf radiance check: fields.rendering_apply_pallas in nerf mode with
   codes (K8b on [view PE | features | code], 315 wide) at 100,352 samples,
   forward and backward through autograd, against rendering_apply, in
   float32 and bf16 (K8b and its backward once each);
15. the probes (monosdf_torch/scripts/probe_hash_primitives.py, the port
   of scripts/probe_hash_primitives.py): its wave functions at full size,
   launches counted from 0, on one case of each Pallas site (PROBE_CASES:
   G, S, R, M, C, each launched 6 times per case), then each kept output
   against its kernel's plain version on the same inputs, and each kernel
   again on seeded random inputs of the same shapes (the probe's own values
   are constant); times, rates, bounds and library calls, and for G, S, R,
   M and C each call's device time (torch.profiler; and with the calls
   queued back to back) and host time, R's copy floor (its rows' bytes at
   3.35 TB/s) and G's shared-memory floor (its reps' reads at 32 a clock
   on each SM);
16. data parallelism (ddp_phase, monosdf_torch/parallel): (a) world size 1
   over NCCL: 3 warm-up and 10 timed DDP steps of the MLP and grid models
   (bf16, full width, distinct 1024-ray batches) in turns with the plain
   step from the same weights, batches and generator seed, the parameters
   bit-equal after every step and each step's launches phase 5's (7's),
   ms a step both ways, a profile of each (busy share, the NCCL kernels'
   device time), DDP's buckets and bytes reduced a step; (b) two spawned
   ranks on cuda:0: NCCL's answer (expected: a refusal), then gloo over
   CUDA tensors, one float32 step of the MLP model through the kernels with
   each rank's draws fixed, against the serial emulation in this process
   (each chunk alone, the gradients averaged, one Adam step) at atol 1e-6
   (the grid model's K5 adds with float atomics: not run there); (c)
   parallel.dryrun_ddp(1): one step of the flagship grids program at full
   size (1024 rays), a finite loss, launching exactly the kernels
   config.routed_kernels names; a worker that fails or outlives
   DDP_DEADLINE_S fails the phase;
17. print a ``render``, a ``train``, a ``render_pe``, a ``train_pe``, a
   ``render_grids``, a ``train_grids``,
   a ``render_codes``, a ``train_codes``, a ``render_codes_split``, a
   ``train_codes_split``, a ``scene``, a ``mesh``, the ``conf``,
   ``conf_grids`` and ``conf_hdr``, a ``quality`` line per quality run, a
   ``mesh_eval``, a ``render_traj``, a ``preprocess``, a ``nerf_radiance``,
   a ``probes`` and a ``ddp`` JSON line, the ``kernels`` JSON line (each
   kernel's launches on every main path, ``launches_conf*`` those of the
   conf runs, ``launches_quality`` those of the quality runs,
   ``launches_preprocess`` the data pipeline's, ``launches_ddp`` the DDP
   steps' and the dryrun's), the card line
   (nvidia-smi's name and power limit), and last the result line.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 (NVIDIA data sheet, SXM, 700 W)
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bytes/s
# SFU results (ex2, rcp: MUFU) per second: 16 per SM per clock (CUDA C
# programming guide, compute capability 9.0) x 132 SMs x the 1.98 GHz boost
# clock the data sheet's float32 peak assumes
H100_SFU_OPS = 16 * 132 * 1.98e9
# shared-memory reads (4 bytes each, no bank conflict) per second: 32 banks
# per SM per clock x 132 SMs x 1.98 GHz
H100_SMEM_READS = 32 * 132 * 1.98e9
SEED = 0
CHUNK = 1024

TPU_KERNELS = {
    "sdf_mlp": "monosdf_tpu/ops/pallas_mlp.py:310",
    "sampler_machinery": "monosdf_tpu/ops/pallas_sampler.py:147",
    "sdf_grad": "monosdf_tpu/ops/pallas_sdf_grad.py:414",
    "radiance_norm": "monosdf_tpu/ops/pallas_rgb_grad.py:708",
    "sdf_grad_bwd": "monosdf_tpu/ops/pallas_sdf_grad.py:713",
    "radiance_norm_bwd": "monosdf_tpu/ops/pallas_rgb_grad.py:889",
    "hash_encode": "monosdf_tpu/ops/pallas_fold.py:353",
    "hash_encode_bwd": "monosdf_tpu/ops/pallas_fold.py:196",
    "sdf_grad_grid": "monosdf_tpu/ops/pallas_sdf_grad_grid.py:165",
    "sdf_grad_grid_bwd": "monosdf_tpu/ops/pallas_sdf_grad_grid.py:351",
    "radiance_split": "monosdf_tpu/ops/pallas_rgb_grad.py:379",
    "radiance_split_bwd": "monosdf_tpu/ops/pallas_rgb_grad.py:538",
    "radiance_mlp": "monosdf_tpu/ops/pallas_rgb_grad.py:122",
    "radiance_mlp_bwd": "monosdf_tpu/ops/pallas_rgb_grad.py:225",
}
# the probes' kernels and the Pallas sites of scripts/probe_hash_primitives.py
# each replaces (the first stands in the kernels line's "replaces")
PROBE_SITES = {
    "probe_gather": ["scripts/probe_hash_primitives.py:154", "scripts/probe_hash_primitives.py:998"],
    "probe_scatter_rows": ["scripts/probe_hash_primitives.py:192",
                           "scripts/probe_hash_primitives.py:534"],
    "probe_row_copy": ["scripts/probe_hash_primitives.py:901"],
    "probe_strided_permute": ["scripts/probe_hash_primitives.py:936"],
    "probe_capacity": ["scripts/probe_hash_primitives.py:495", "scripts/probe_hash_primitives.py:853"],
}
TPU_KERNELS.update({name: sites[0] for name, sites in PROBE_SITES.items()})
# K1-PE: K1's library on raw points (kernel_pe, inside the pl.pallas_call at :310)
TPU_KERNELS["sdf_mlp_pe"] = "monosdf_tpu/ops/pallas_mlp.py:140"
# and the launches of the order references (build.reference_launches: K2f's
# SIMT kernel for the render chunk's kernel, K4 at depth 1 for the
# speculative bisection), which no main path makes
_NONE = dict.fromkeys([*TPU_KERNELS, "sdf_grad_simt", "sampler_machinery_seq"], 0)
PER_CHUNK = {**_NONE, "sdf_mlp": 5, "sampler_machinery": 5, "sdf_grad": 1, "radiance_norm": 1}
PER_STEP = {**PER_CHUNK, "sdf_grad_bwd": 1, "radiance_norm_bwd": 1}
# the grid model: 4 sampler sweeps (K1 on [PE | K6 features of 6 levels])
# and 4 machinery calls, one differentiated encode (K6) and trunk (K7f);
# training adds K7b and the table gradient K5
PER_CHUNK_GRIDS = {**_NONE, "sdf_mlp": 4, "sampler_machinery": 4, "hash_encode": 5,
                   "sdf_grad_grid": 1}
PER_STEP_GRIDS = {**PER_CHUNK_GRIDS, "sdf_grad_grid_bwd": 1, "hash_encode_bwd": 1}
# the union model: the MLP model's launches with K3 (codes through K3's
# code operand); with rgb_backend 'pallas' K8a and its backward in K3's place
PER_CHUNK_SPLIT = {**PER_CHUNK, "radiance_norm": 0, "radiance_split": 1}
PER_STEP_SPLIT = {**PER_CHUNK_SPLIT, "sdf_grad_bwd": 1, "radiance_split_bwd": 1}
# the MLP model with sweep_pe_in_kernel: its 5 sweeps through K1-PE, none through K1
PER_CHUNK_PE = {**PER_CHUNK, "sdf_mlp": 0, "sdf_mlp_pe": 5}
PER_STEP_PE = {**PER_STEP, "sdf_mlp": 0, "sdf_mlp_pe": 5}
# the main paths: JSON tag, launches per chunk and per step
PATHS = {
    "mlp": ("", PER_CHUNK, PER_STEP),
    "pe": ("_pe", PER_CHUNK_PE, PER_STEP_PE),
    "grids": ("_grids", PER_CHUNK_GRIDS, PER_STEP_GRIDS),
    "codes": ("_codes", PER_CHUNK, PER_STEP),
    "codes_split": ("_codes_split", PER_CHUNK_SPLIT, PER_STEP_SPLIT),
}
SWEEPS = ("sdf_mlp", "sdf_mlp_pe", "sampler_machinery")  # the sampler's kernels
# the libraries whose bf16 kernels run on the tensor cores (wgmma: HGMMA in SASS)
TENSOR_CORE_LIBS = ("sdf_mlp", "sdf_grad", "sdf_grad_bwd", "sdf_grad_grid_bwd", "radiance_norm_bwd",
                    "sdf_grad_grid", "radiance_norm", "radiance_split", "radiance_split_bwd",
                    "radiance_mlp", "radiance_mlp_bwd")
WARMUP_STEPS, TIMED_STEPS = 3, 20
# stated tolerances, kernel vs plain version on the card: err <= atol + rtol * max|plain|;
# bf16: a rounding that lands on the neighbouring bf16 value (ulp 2^-7 at 1)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}
# K4's pdf entry by entry, |a - b| <= atol + rtol * |b|: its entries run from
# add_tiny (1e-6) to ~1e3. float32: sums in another order (~1e-7 relative);
# bf16: a scanned term rounded to the neighbouring bf16 value.
K4_PDF_TOL = {"float32": (1e-6, 1e-4), "bfloat16": (1e-5, 2e-2)}
# renders with each kernel's plain version in its wrapper's place (max abs
# per output), against the kernel render:
# - at the kernel render's own samples (render_samples): K2 and K3 alone.
#   float32: the repo's per-component tolerance 2e-5 (sums in another
#   order); bf16: an activation rounded to the neighbouring bf16 value
#   moves a gradient by ~1e-2 through 5 layers (as tests/test_torch_kernels.py).
RENDER_FIXED_MAX_ABS = {
    "float32": {"rgb_values": 2e-5, "depth_values": 2e-5, "normal_map": 2e-5},
    "bfloat16": {"rgb_values": 1e-3, "depth_values": 1e-3, "normal_map": 1e-2},
}
# - through the sampler: the error-bounded sampler draws from a pdf that
#   turns the sweep SDF's float32 sum-order differences (K1) into moved
#   samples (z_vals, printed), and weights shift between them. rgb hardly
#   moves; depth and normals, which vary more between samples, move more.
RENDER_LIKE_MAX_ABS = {
    "float32": {"rgb_values": 1e-4, "depth_values": 2e-3, "normal_map": 1e-2},
    "bfloat16": {"rgb_values": 1e-3, "depth_values": 2e-3, "normal_map": 5e-2},
}
# - the union model through the sampler: its white background adds (1 -
#   sum of the weights) to rgb, so weights that move with the samples move
#   rgb as they move depth; in bf16 the sampler moved a sample on 11,712 of
#   16,384 rays (by up to 2.1e-2), rgb by 1.7e-3 and depth by 2.3e-3, while
#   at fixed samples they agreed to 1.6e-4 and 8.4e-4 (NVIDIA H100 80GB
#   HBM3, 700 W; PERF.md). float32 as the MLP model's.
RENDER_LIKE_MAX_ABS_CODES = {
    "float32": RENDER_LIKE_MAX_ABS["float32"],
    "bfloat16": {"rgb_values": 5e-3, "depth_values": 5e-3, "normal_map": 5e-2},
}
# K2b and K3b parameter gradients, kernel vs plain version: each is a sum
# over ~4e5 (K2b) or ~1e5 (K3b) rows, so per tensor err <= atol + rtol *
# max|plain|. float32: the repo's kernel parameter-grad bar, sums in another
# order; bf16: the operands are bf16 in both and the float32 sums run in
# another order, so a rounding lands on the neighbouring bf16 value (2^-8
# relative) now and then. K3b's dg uses the same bar, its df TOL.
GRAD_TOL = {"float32": (2e-4, 1e-3), "bfloat16": (1e-2, 2e-2)}
# K6 (the encode) vs its plain version, per tensor: both read the same corner
# values (float32 or bf16) and combine them in float32 with float32 weights,
# so a bf16 table holds at the float32 bar too; the features (~1e-2 here)
# stay well above it, so a zero or wrong-row output cannot pass.
ENCODE_TOL = (1e-4, 1e-4)
# K5 (the table gradient) row by row, |a - b| <= atol + rtol * S, S the sum
# over the corner terms added into that row of the magnitudes each is made
# from, |c_feat| W + sum_k |c_tg_k| |dW/dx_k| (a term's parts cancel, so
# its float32 rounding scales with them, not with the term). float32: that
# rounding and the atomics' run-dependent order (below n 2^-24 S for a row
# of n <= ~1e3 terms); bf16: besides, a term rounded to bf16 may land on the
# neighbouring value (one ulp, <= 2^-7 of the term).
ENCODE_BWD_TOL = {"float32": (1e-6, 1e-4), "bfloat16": (1e-6, 2**-7 + 1e-4)}
# the like-for-like training step (kernels vs plain versions at fixed
# samples): float32 element by element, |a - b| <= atol + rtol * |b|, the
# JAX package's bar for kernel parameter gradients (ROADMAP.md Tolerances;
# tests/test_pallas_sdf_grad.py:91-93); bf16 per tensor, |a - b| <= atol +
# rtol * max|plain|: bf16 activations, Z and cotangents that land on the
# neighbouring bf16 value (2^-8 relative) in one path and not the other, two
# bf16 ulps (2^-7) of the tensor's largest entry bound their sum. The loss:
# relative 1e-5 (float32) and 1e-3 (bf16).
STEP_TOL = {"float32": (2e-4, 1e-3, 1e-5), "bfloat16": (1e-4, 2e-2, 1e-3)}
PROFILE_CHUNKS = 3

def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 10) -> float:
    """Device ms per call of fn spent in ``kernel`` (a name of
    build.SOURCES): one torch.profiler session over 3 ``reps`` calls, each
    device function of the kernel (each runs once a launch) at the mean
    duration of its recorded events, times the kernel's launches per call.
    The profiler drops device events, at a session's start or all of them
    where it places the device's clock off the host's, so a session's sum
    over its calls can read short (``scripts/kernel_ab.py
    --profiler_check``); a short session late in a long run lost all of
    them, so the calls run between two sleep kernels of ~5 ms each inside
    the session (twice that at each retry), away from its edges. Fails
    where it recorded none of the kernel's."""
    from monosdf_torch.kernels import build

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        before = dict(build.launches)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(10_000_000 << attempt)  # device clock cycles
            for _ in range(3 * reps):
                fn()
            torch.cuda._sleep(10_000_000 << attempt)
            torch.cuda.synchronize()
        per_call = (build.launches[kernel] - before[kernel]) / (3 * reps)
        durations: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and _of(kernel, e.name):
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if durations and per_call > 0:
            return per_call * sum(sum(d) / len(d) for d in durations.values()) / 1e3
        print(f"device_ms: torch.profiler recorded no device event of {kernel} in "
              f"{3 * reps} calls; profiling again", flush=True)
    fail(f"torch.profiler recorded no device time for {kernel}")


def queued_ms(fn, calls: int = 20) -> float:
    """Device ms per call of fn with the calls queued behind a sleep kernel,
    so that they run back to back without host gaps (CUDA events around
    them: the call's device work and the device's gaps between launches;
    a reading beside the profiler's)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of device clock cycles
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int = 100) -> float:
    """Host us per call of fn with the stream kept busy (a sleep kernel
    queued first), so that each call's launch is only enqueued."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device clock cycles
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def k4_inputs(rng, dev, n_iters: int, n_eval: int, rays: int = CHUNK, beta0: float = 0.01) -> list:
    """K4's synthetic inputs, one per sampler iteration it (N = n_eval (it
    + 1) sorted samples in [0, 3.85] a ray, an SDF crossing zero once, with
    noise): (sdf, dists_tail, d_star, beta_prev, beta0, last)."""
    from monosdf_torch.ops.sampler import _d_star

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    out = []
    for it in range(n_iters):
        N = n_eval * (it + 1)
        z = np.sort(rng.uniform(0.0, 3.85, (rays, N)), axis=-1)
        sdf = np.tanh(rng.uniform(0.8, 2.5, (rays, 1)) - z) * 0.6
        sdf = sdf + 0.01 * rng.normal(size=sdf.shape)
        dists = np.diff(z, axis=-1)
        zt, st = t(z), t(sdf)
        dt = t(np.concatenate([dists, np.full((rays, 1), 1e10)], -1))
        ds = torch.nn.functional.pad(_d_star(zt, st), (0, 1)).contiguous()
        bp = t(np.sqrt(np.sum(dists**2, -1) / (4 * math.log(1.1)))[:, None])
        out.append((st, dt, ds, bp, torch.tensor(beta0, device=dev), it == n_iters - 1))
    return out


def grid_step_points(cfg, dev):
    """The points K6 (and K5) take in one training step of the grid model
    ``cfg`` on the synthetic scene's first batch, where the model's sampler
    places them: (the sweeps' (points, levels read), one pair each; the
    differentiated encode's points, the samples and the eikonal batch)."""
    from monosdf_torch.cli.train import make_trainer, ray_batches
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.kernels import hash_encode as k6
    from monosdf_torch.models import fields
    from monosdf_torch.models.monosdf import init_monosdf

    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    batch = ray_batches(scene, np.random.default_rng(SEED), 1, CHUNK, dev)[0]
    model = init_monosdf(cfg, seed=SEED, device=dev)
    step = make_trainer(model, cfg)
    sweeps, diff = [], []
    encode = k6.hash_encode_fwd

    def record(table, g, x, size=1.0, n_levels=None, tangents=False, tangent_scale=1.0):
        (diff if tangents else sweeps).append((x.detach().clone(), n_levels))
        return encode(table, g, x, size, n_levels, tangents, tangent_scale)

    # the sweeps call fields' name of the wrapper, encode_diff the module's
    k6.hash_encode_fwd = fields.hash_encode_fwd = record
    try:
        step(model, batch, generator=torch.Generator(device=dev).manual_seed(SEED))
    finally:
        k6.hash_encode_fwd = fields.hash_encode_fwd = encode
    torch.cuda.synchronize()
    if len(diff) != 1 or not sweeps:
        fail(f"the grid step encoded {len(sweeps)} sweeps and {len(diff)} differentiated sets")
    return sweeps, diff[0][0]


def max_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()), float(b.abs().max())


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlp_flops(ws, rows: int) -> float:
    return 2.0 * rows * sum(w.shape[0] * w.shape[1] for w in ws)


def bits_equal(a, b) -> bool:
    """The same dtype, shape and bits (a bf16 or float32 tensor)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def launch_counts() -> dict:
    """The launches counted since the last reset: each kernel's, and K2f's
    order reference's."""
    from monosdf_torch.kernels import build

    return {**build.launches, **build.reference_launches}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def sass_counts(libs, opcode: str) -> dict:
    """The instructions of ``opcode`` in the SASS of each library of
    ``libs`` (cuobjdump beside nvcc)."""
    from pathlib import Path

    from monosdf_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    counts = {}
    for name in libs:
        sass = subprocess.run([str(tool), "-sass", str(build.lib_path(name))], check=True,
                              capture_output=True, text=True).stdout
        counts[name] = sum(opcode in line for line in sass.splitlines())
    return counts


def perturbed_model(cfg, device, scale: float = 0.01):
    """The bench model's geometric init plus seeded normal noise on every
    parameter, so the SDF is not a pure sphere."""
    from monosdf_torch.models.monosdf import init_monosdf

    model = init_monosdf(cfg, seed=SEED, device=device)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 0:
                p.add_(scale * torch.randn(p.shape, generator=gen).to(device))
    return model


_KERNEL_FNS: dict = {}  # (module, name) -> the kernel wrapper there, saved at the first swap


def use_plain_versions(on: bool):
    """Point the kernel path's call sites at each kernel's plain version
    (``on``) or back at the kernel wrappers: the sweeps' K1 and K6 and the
    sampler's K4, inside the K2, K3 and K7 modules the forward that both the
    no-grad call and the autograd Function run and the backward that the
    Function's backward runs (K8a and K8b too), and inside the K6/K5 module the encode and
    table gradient that its autograd Function runs. A wrapper launches its
    kernel on a CUDA tensor, so this is how the card runs the kernel path's
    own composition with the plain versions."""
    from monosdf_torch.kernels import hash_encode as k6
    from monosdf_torch.kernels import radiance_mlp as k8b
    from monosdf_torch.kernels import radiance_norm as k3
    from monosdf_torch.kernels import radiance_split as k8a
    from monosdf_torch.kernels import sdf_grad as k2
    from monosdf_torch.kernels import sdf_grad_grid as k7
    from monosdf_torch.kernels import sdf_mlp as k1
    from monosdf_torch.models import fields

    for mod, name, plain in (
        # K1, K4, K2f and K3f at the render path's call sites
        *((mod, name, plain) for _, mod, name, plain in _render_kernel_sites()),
        # the sweeps hand K1 its packed weights, which the plain version has no use for
        (fields, "sdf_mlp_pe", lambda *a, packed=None, **kw: k1.sdf_mlp_pe_plain(*a, **kw)),
        (fields, "hash_encode_fwd", k6.hash_encode_fwd_plain),
        (k2, "sdf_mlp_with_grad_bwd", k2.sdf_mlp_with_grad_bwd_plain),
        (k3, "radiance_norm_bwd", k3.radiance_norm_bwd_plain),
        (k6, "hash_encode_fwd", k6.hash_encode_fwd_plain),
        (k6, "hash_encode_bwd", k6.hash_encode_bwd_plain),
        (k7, "_forward", k7.sdf_mlp_with_grad_in_plain),
        (k7, "sdf_mlp_with_grad_in_bwd", k7.sdf_mlp_with_grad_in_bwd_plain),
        (k8a, "_forward", k8a.radiance_split_plain),
        (k8a, "radiance_split_bwd", k8a.radiance_split_bwd_plain),
        (k8b, "_forward", k8b.mlp_plain),
        (k8b, "mlp_with_input_grad_bwd", k8b.mlp_bwd_plain),
    ):
        kernel = _KERNEL_FNS.setdefault((mod, name), getattr(mod, name))
        setattr(mod, name, plain if on else kernel)


# ---------------------------------------------------------------------------


def kernel_checks(model, cfg, dev):
    """Phase 3: each kernel against its plain version at one chunk's shapes."""
    from monosdf_torch.kernels import radiance_norm as k3
    from monosdf_torch.kernels import sampler_machinery as k4
    from monosdf_torch.kernels import sdf_grad as k2
    from monosdf_torch.kernels import sdf_mlp as k1
    from monosdf_torch.models.fields import effective_linear_weights
    from monosdf_torch.ops.embedder import positional_encoding

    rng = np.random.default_rng(SEED)
    imp = cfg.implicit
    S = cfg.sampler.total_samples
    n_sweep, n_main = CHUNK * cfg.sampler.N_samples_eval, CHUNK * S
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    results = {}
    ok = True
    with torch.no_grad():
        ws, bs = effective_linear_weights(model.implicit)
        ws_sweep = ws[:-1] + [ws[-1][:, :1].contiguous()]
        bs_sweep = bs[:-1] + [bs[-1][:1].contiguous()]
        rws, rbs = effective_linear_weights(model.rendering)
        x_sweep = t(rng.uniform(-1.1, 1.1, (n_sweep, 3)))
        emb = positional_encoding(x_sweep, imp.multires)
        x_main = t(rng.uniform(-1.1, 1.1, (n_main, 3)))
        g = t(rng.normal(size=(n_main, 3)))
        sv = torch.cat([x_main, positional_encoding(t(rng.normal(size=(n_main, 3))), 4)], -1)
        feat = t(rng.normal(size=(n_main, imp.feature_vector_size)))
        k4_in = k4_inputs(rng, dev, cfg.sampler.max_total_iters, cfg.sampler.N_samples_eval)

        # K1 and K1-PE as the sweeps call them: the weights packed once
        pk = k1.pack(ws_sweep, bs_sweep, imp.skip_in)
        cases = {
            "sdf_mlp": (
                lambda d: [k1.sdf_mlp(ws_sweep, bs_sweep, emb, imp.skip_in, d, packed=pk)],
                lambda d: [k1.sdf_mlp_plain(ws_sweep, bs_sweep, emb, imp.skip_in, d)],
            ),
            "sdf_mlp_pe": (
                lambda d: [k1.sdf_mlp_pe(ws_sweep, bs_sweep, x_sweep, imp.multires, imp.skip_in,
                                         d, packed=pk)],
                lambda d: [k1.sdf_mlp_pe_plain(ws_sweep, bs_sweep, x_sweep, imp.multires,
                                               imp.skip_in, d)],
            ),
            "sdf_grad": (
                lambda d: list(k2.sdf_mlp_with_grad(ws, bs, x_main, imp.multires, imp.skip_in, d,
                                                    imp.sdf_bounding_sphere, imp.sphere_scale)),
                lambda d: list(k2.sdf_mlp_with_grad_plain(ws, bs, x_main, imp.multires,
                                                          imp.skip_in, d, imp.sdf_bounding_sphere,
                                                          imp.sphere_scale)),
            ),
            "radiance_norm": (
                lambda d: list(k3.radiance_norm(rws, rbs, g, sv, feat, d)),
                lambda d: list(k3.radiance_norm_plain(rws, rbs, g, sv, feat, d)),
            ),
            "sampler_machinery": (
                lambda d: [o for a in k4_in for o in k4.sampler_iter_machinery(
                    *a[:5], 0.1, 1e-6, a[5], 10, d)],
                lambda d: [o for a in k4_in for o in k4.sampler_iter_machinery_plain(
                    *a[:5], 0.1, 1e-6, a[5], 10, d)],
            ),
        }
        for name, (kern, plain) in cases.items():
            res = {}
            for dname, d in (("float32", None), ("bfloat16", torch.bfloat16)):
                out_k, out_p = kern(d), plain(d)
                torch.cuda.synchronize()
                atol, rtol = TOL[dname]
                errs = []  # (max abs err, max|plain|, err over its tolerance)
                for i, (a, b) in enumerate(zip(out_k, out_p)):
                    if not torch.isfinite(a.float()).all():
                        fail(f"{name} {dname}: output {i} not finite")
                    err, scale = max_err(a, b)
                    if name == "sampler_machinery" and i % 2 == 0:
                        # beta: a bisection step that flips moves beta by one
                        # halving of [beta0, beta_prev]
                        ratio = err / (float(k4_in[i // 2][3].max()) / 2**10)
                    elif name == "sampler_machinery":
                        pa, pr = K4_PDF_TOL[dname]
                        d_ab = (a.float() - b.float()).abs()
                        ratio = float((d_ab / (pa + pr * b.float().abs())).max())
                    else:
                        ratio = err / (atol + rtol * scale)
                    errs.append((err, scale, ratio))
                worst = max(errs, key=lambda e: e[2])
                print(f"check {name:17s} {dname:8s} max_abs_err {max(e[0] for e in errs):.3e} "
                      f"max_rel_err {worst[0] / max(worst[1], 1e-30):.3e} "
                      f"(max|plain| {worst[1]:.3e}); worst err / tolerance {worst[2]:.3e} "
                      f"{'ok' if worst[2] <= 1.0 else 'FAIL'}", flush=True)
                ok = ok and worst[2] <= 1.0
                res[dname] = max(e[0] for e in errs)
            results[name] = {"max_abs_err": res["bfloat16"], "max_abs_err_f32": res["float32"]}

        # times at bf16 (the bench configuration), per launch; K4's over its 5 shapes
        bf = torch.bfloat16
        for name, (kern, plain) in cases.items():
            k = cuda_ms(lambda: kern(bf))
            p = cuda_ms(lambda: plain(bf), reps=3, warmup=1)
            n = len(k4_in) if name == "sampler_machinery" else 1
            results[name].update(ms=k / n, plain_ms=p / n)

        # K2f's render chunk kernel against its order reference, the SIMT
        # kernel, at bf16: bit for bit on the MLP model's trunk (with its
        # SDF clamp) and on the union model's (no clamp), and the reference's
        # time on the same inputs
        from monosdf_torch.cli.eval import union_codes_config

        union = perturbed_model(union_codes_config("bfloat16"), dev)
        trunks = {"mlp": (ws, bs, imp.sdf_bounding_sphere),
                  "union": (*effective_linear_weights(union.implicit), 0.0)}
        del union
        same_all = True
        for tag, (tw, tb, sphere) in trunks.items():
            args = (tw, tb, x_main, imp.multires, imp.skip_in, bf, sphere, imp.sphere_scale)
            out_k, out_r = k2.sdf_mlp_with_grad(*args), k2.sdf_mlp_with_grad_simt(*args)
            torch.cuda.synchronize()
            same = all(bits_equal(a, b) for a, b in zip(out_k, out_r))
            err = max(max_err(a, b)[0] for a, b in zip(out_k, out_r))
            print(f"check sdf_grad chunk vs its SIMT order reference, {tag} trunk, bf16: "
                  f"{'bit-equal' if same else 'DIFFERENT'} (max abs diff {err:.3e}) "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            same_all = same_all and same
        ok = ok and same_all
        args = (ws, bs, x_main, imp.multires, imp.skip_in, bf, imp.sdf_bounding_sphere,
                imp.sphere_scale)
        results["sdf_grad"].update(
            bit_equal_simt_reference=same_all,
            ms_simt_reference=cuda_ms(lambda: k2.sdf_mlp_with_grad_simt(*args), reps=5))

        # K4's speculative kernel against its order reference, the same
        # kernel at depth 1 (the sequential bisection, div.rn throughout):
        # bit for bit on the phase's 5 shapes, float32 and bf16; the
        # reference's time; device time per launch (torch.profiler) and the
        # wrapper's host time per call
        same_k4 = True
        for dname, d in (("float32", None), ("bfloat16", bf)):
            out_k = [o for a in k4_in for o in k4.sampler_iter_machinery(
                *a[:5], 0.1, 1e-6, a[5], 10, d)]
            out_r = [o for a in k4_in for o in k4.sampler_iter_machinery_seq(
                *a[:5], 0.1, 1e-6, a[5], 10, d)]
            torch.cuda.synchronize()
            same = all(bits_equal(a, b) for a, b in zip(out_k, out_r))
            print(f"check sampler_machinery vs its sequential order reference, {dname}: "
                  f"{'bit-equal' if same else 'DIFFERENT'} {'ok' if same else 'FAIL'}", flush=True)
            same_k4 = same_k4 and same
        ok = ok and same_k4
        k4_beta = out_k[0::2]  # bf16's, for the bound
        seq = lambda: [k4.sampler_iter_machinery_seq(*a[:5], 0.1, 1e-6, a[5], 10, bf)
                       for a in k4_in]
        n4 = len(k4_in)
        results["sampler_machinery"].update(
            bit_equal_seq_reference=same_k4, ms_seq_reference=cuda_ms(seq) / n4,
            device_ms=device_ms(lambda: cases["sampler_machinery"][0](bf),
                                "sampler_machinery") / n4,
            device_ms_per_shape=[device_ms(lambda a=a: k4.sampler_iter_machinery(
                *a[:5], 0.1, 1e-6, a[5], 10, bf), "sampler_machinery") for a in k4_in],
            host_us=host_us(lambda: k4.sampler_iter_machinery(*k4_in[0][:5], 0.1, 1e-6,
                                                              k4_in[0][5], 10, bf)))

    # bounds: the least time for this work on an H100 SXM (700 W)
    sweep_flops = mlp_flops(ws_sweep, n_sweep)
    sweep_bytes = nbytes(emb) / 2 + n_sweep * 4 + nbytes(*ws_sweep, *bs_sweep)
    k2_flops = mlp_flops(ws, n_main) + mlp_flops(ws[:-1], 3 * n_main) + 2.0 * 3 * n_main * ws[-1].shape[0]
    k2_bytes = n_main * (3 * 4 + 4 + imp.feature_vector_size * 2 + 3 * 4) + nbytes(*ws, *bs)
    k3_flops = mlp_flops(rws, n_main)
    k3_bytes = n_main * (3 * 4 + sv.shape[1] * 2 + feat.shape[1] * 2 + 3 * 4 + 3 * 4) + nbytes(*rws, *rbs)
    # K4: the error bounds this run's rays need, the sequential loop's: the
    # bound at beta0 and, where it is above eps, 10 bisection steps (a ray
    # whose beta comes back as beta0 needs the first only); then the
    # density, transmittance and pdf. Per sample and error bound ~20 FLOP
    # and 4 exp, each one ex2 on the SFU; per ray and error bound 2
    # reciprocals (beta, 4 beta^2), the divisions then FMAs; the last step 4
    # exp a sample (3 with `last`) and 2 reciprocals a ray
    k4_b, k4_f, k4_sfu, k4_early = 0.0, 0.0, 0.0, 0
    for (st, dt, ds, bp, b0, last), beta in zip(k4_in, k4_beta):
        R, N = st.shape
        early = int((beta.flatten() == b0).sum())
        n_bounds = early + 11 * (R - early)
        k4_early += early
        k4_b += 4.0 * (4 * R * N + 2 * R)
        k4_f += N * (20 * n_bounds + 12 * R)
        k4_sfu += (4 * N + 2) * n_bounds + R * ((3 if last else 4) * N + 2)
    bounds = {
        "sdf_mlp": bound_ms(sweep_flops, sweep_bytes, H100_BF16_FLOPS),
        # K1-PE reads the points (float32) instead of the embedding
        "sdf_mlp_pe": bound_ms(sweep_flops, nbytes(x_sweep) + n_sweep * 4 + nbytes(*ws_sweep, *bs_sweep),
                               H100_BF16_FLOPS),
        "sdf_grad": bound_ms(k2_flops, k2_bytes, H100_BF16_FLOPS),
        "radiance_norm": bound_ms(k3_flops, k3_bytes, H100_BF16_FLOPS),
        "sampler_machinery": bound_ms(k4_f / len(k4_in), k4_b / len(k4_in), H100_F32_FLOPS),
    }
    # K4 at the SFU rate: operations too, and the larger term
    sfu_ms = k4_sfu / len(k4_in) / H100_SFU_OPS * 1e3
    if sfu_ms > bounds["sampler_machinery"][0]:
        bounds["sampler_machinery"] = (sfu_ms, "operations")
    results["sampler_machinery"].update(
        bound_sfu_ms=sfu_ms, bound_unit="sfu" if sfu_ms >= bounds["sampler_machinery"][0] else None,
        rays_beta0=k4_early / sum(a[0].shape[0] for a in k4_in))
    for name, (b, by) in bounds.items():
        results[name].update(bound_ms=b, bound_by=by)
    # the render chunk's kernel runs on the CUDA cores: its floor at their
    # float32 FMA peak (bound_ms assumes the bf16 tensor cores')
    results["sdf_grad"]["fp32_floor_ms"] = k2_flops / H100_F32_FLOPS * 1e3
    if not ok:
        fail("a kernel disagrees with its plain version beyond the stated tolerance")
    return results


def _ratio(pairs, atol, rtol):
    """Worst err / (atol + rtol * max|plain|) over (kernel, plain) pairs,
    and the largest max abs err."""
    worst, big = 0.0, 0.0
    for a, b in pairs:
        if not torch.isfinite(a.float()).all():
            fail(f"non-finite kernel output of shape {tuple(a.shape)}")
        err, scale = max_err(a, b)
        worst, big = max(worst, err / (atol + rtol * scale)), max(big, err)
    return worst, big


def training_kernel_checks(model, cfg, dev, results):
    """Phase 3 at the training step's shapes: K2f's training variant
    (clamp_rows, flag, saved Z) and K2b at the step's n_main + 4R points
    (the folded eikonal batch unclamped), K3b at its n_main samples, each
    against its plain version, in float32 and bf16; times and bounds."""
    from monosdf_torch.kernels import radiance_norm as k3
    from monosdf_torch.kernels import sdf_grad as k2
    from monosdf_torch.models.fields import effective_linear_weights
    from monosdf_torch.ops.embedder import positional_encoding

    rng = np.random.default_rng(SEED + 2)
    imp = cfg.implicit
    n_main = CHUNK * cfg.sampler.total_samples
    N = n_main + 4 * CHUNK
    F = imp.feature_vector_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    ok = True
    with torch.no_grad():
        ws, bs = effective_linear_weights(model.implicit)
        rws, rbs = effective_linear_weights(model.rendering)
        x = t(rng.uniform(-1.1, 1.1, (N, 3)))  # the cube's corners lie outside the 1.1 sphere
        cots = [t(rng.normal(size=(N, k))) for k in (1, F, 3)]
        g = t(rng.normal(size=(n_main, 3)))
        sv = torch.cat([x[:n_main], positional_encoding(t(rng.normal(size=(n_main, 3))), 4)], -1)
        feat = t(rng.normal(size=(n_main, F)))
        co, cn = t(rng.normal(size=(n_main, 3))), t(rng.normal(size=(n_main, 3)))

        def fwd(d, plain=False):
            fn = k2.sdf_mlp_with_grad_plain if plain else k2.sdf_mlp_with_grad
            return fn(ws, bs, x, imp.multires, imp.skip_in, d, imp.sdf_bounding_sphere,
                      imp.sphere_scale, n_main, True)

        def k2b(d, zs, flag, plain=False):
            fn = k2.sdf_mlp_with_grad_bwd_plain if plain else k2.sdf_mlp_with_grad_bwd
            dws, dbs = fn(ws, bs, x, zs, *cots, imp.multires, imp.skip_in, d, flag)
            return [*dws, *dbs]

        def k3b(d, plain=False):
            fn = k3.radiance_norm_bwd_plain if plain else k3.radiance_norm_bwd
            dws, dbs, dg, df, _ = fn(rws, rbs, g, sv, feat, co, cn, d)
            return [*dws, *dbs, dg], df

        errs = {"sdf_grad_train": {}, "sdf_grad_bwd": {}, "radiance_norm_bwd": {}}
        for dname, d in (("float32", None), ("bfloat16", torch.bfloat16)):
            out, ref = fwd(d), fwd(d, plain=True)
            torch.cuda.synchronize()
            # where the take-MLP select flips (an SDF within a rounding of
            # the sphere's), sdf and grad take the other branch: count those
            same = (out[3] == ref[3])[:, 0]
            flips = int((~same).sum())
            max_flips = 1e-4 * N if d is None else 1e-3 * N
            r_f, e_f = _ratio([(out[0][same], ref[0][same]), (out[1], ref[1]),
                               (out[2][same], ref[2][same]), *zip(out[4], ref[4])], *TOL[dname])
            zs, flag = out[4], out[3]
            del ref
            r_b, e_b = _ratio(zip(k2b(d, zs, flag), k2b(d, zs, flag, plain=True)),
                              *GRAD_TOL[dname])
            (gk, dfk), (gp, dfp) = k3b(d), k3b(d, plain=True)
            r_3, e_3 = _ratio(zip(gk, gp), *GRAD_TOL[dname])
            r_3f, e_3f = _ratio([(dfk, dfp)], *TOL[dname])
            for name, r, e, extra in (("sdf_grad_train", r_f, e_f, f"; flag flips {flips}"),
                                      ("sdf_grad_bwd", r_b, e_b, ""),
                                      ("radiance_norm_bwd", max(r_3, r_3f), max(e_3, e_3f), "")):
                good = r <= 1.0 and (name != "sdf_grad_train" or flips <= max_flips)
                print(f"check {name:17s} {dname:8s} max_abs_err {e:.3e}; worst err / tolerance "
                      f"{r:.3e}{extra} {'ok' if good else 'FAIL'}", flush=True)
                ok = ok and good
                errs[name][dname] = e
            del out, zs
        results["sdf_grad"].update(max_abs_err_train=errs["sdf_grad_train"]["bfloat16"],
                                   max_abs_err_train_f32=errs["sdf_grad_train"]["float32"])
        for name in ("sdf_grad_bwd", "radiance_norm_bwd"):
            results[name] = {"max_abs_err": errs[name]["bfloat16"],
                             "max_abs_err_f32": errs[name]["float32"]}

        # times at bf16, per launch
        bf = torch.bfloat16
        _, _, _, flag, zs = fwd(bf)
        results["sdf_grad"].update(ms_train=cuda_ms(lambda: fwd(bf), reps=5),
                                   plain_ms_train=cuda_ms(lambda: fwd(bf, True), reps=2, warmup=1))
        results["sdf_grad_bwd"].update(
            ms=cuda_ms(lambda: k2b(bf, zs, flag), reps=5),
            plain_ms=cuda_ms(lambda: k2b(bf, zs, flag, True), reps=2, warmup=1))
        results["radiance_norm_bwd"].update(ms=cuda_ms(lambda: k3b(bf)),
                                            plain_ms=cuda_ms(lambda: k3b(bf, True), reps=3,
                                                             warmup=1))
        z_bytes = nbytes(*zs)
        del zs

    # bounds: the FLOP each function needs at these shapes, and its bytes
    # (each input read once, each output written once)
    kin_l, n_l = ws[-1].shape
    fwd_flops = mlp_flops(ws[:-1], 4 * N) + 2.0 * N * kin_l * n_l + 2.0 * 3 * N * kin_l
    prop_flops = mlp_flops(ws[1:-1], 4 * N) + 2.0 * N * kin_l * n_l + 2.0 * 3 * N * kin_l
    w_bytes = nbytes(*ws, *bs)
    k2f_bytes = N * (3 * 4 + 4 + F * 2 + 3 * 4 + 4) + z_bytes + w_bytes
    k2b_bytes = N * (3 * 4 + (1 + F + 3) * 2 + 4) + z_bytes + 2 * w_bytes
    n0 = rws[0].shape[1]
    k3b_flops = (mlp_flops(rws[:-1], n_main) + mlp_flops(rws, n_main) + mlp_flops(rws[1:], n_main)
                 + 2.0 * n_main * n0 * (3 + F))
    k3b_bytes = (n_main * (3 * 4 + sv.shape[1] * 2 + F * 2 + 3 * 2 + 3 * 2 + 3 * 4 + F * 2)
                 + 2 * nbytes(*rws, *rbs))
    b, by = bound_ms(fwd_flops, k2f_bytes, H100_BF16_FLOPS)
    results["sdf_grad"].update(bound_ms_train=b, bound_by_train=by)
    for name, fl, nb in (("sdf_grad_bwd", fwd_flops + prop_flops, k2b_bytes),
                         ("radiance_norm_bwd", k3b_flops, k3b_bytes)):
        b, by = bound_ms(fl, nb, H100_BF16_FLOPS)
        results[name].update(bound_ms=b, bound_by=by)
    # K1's and K1-PE's sweep times (phase 3) beside K2's and K3b's
    shown = ("sdf_mlp", "sdf_mlp_pe", "sdf_grad", "sdf_grad_bwd", "radiance_norm_bwd")
    print(f"train-shape kernels (bf16, ms per launch): {json.dumps({k: {kk: v for kk, v in r.items() if 'ms' in kk or 'bound' in kk} for k, r in results.items() if k in shown})}", flush=True)
    if not ok:
        fail("a training kernel disagrees with its plain version beyond the stated tolerance")


def _row_ratio(d, dp, gcfg, x, c_feat, c_tg, tangent_scale, atol, rtol):
    """K5 against its plain version row by row: the worst |d - dp| / (atol +
    rtol * S), and the largest max abs err. S is each row's sum, over the
    corner terms added into it, of |c_feat| W + sum_k |c_tg_k| |dW/dx_k|:
    the magnitude each term is summed from, which scales its float32
    rounding where the parts cancel."""
    from monosdf_torch.ops.hashgrid import corner_geometry, corner_weights

    if not torch.isfinite(d).all():
        fail(f"non-finite kernel output of shape {tuple(d.shape)}")
    N, L = x.shape[0], gcfg.num_levels
    idx, w, dw, inb = corner_geometry(gcfg, x, 1.0, L, tangent_scale)
    W, dW = corner_weights(w, dw)
    cf = (c_feat.reshape(N, L, 2).abs() * inb[:, None, None]).permute(1, 0, 2)
    ct = (c_tg.reshape(3, N, L, 2).abs() * inb[None, :, None, None]).permute(0, 2, 1, 3)
    mag = W[..., None] * cf[None] + torch.einsum("jcln,jlnd->clnd", dW.abs(), ct)
    s = torch.zeros(gcfg.table_size, 2, device=d.device).index_add_(
        0, idx.reshape(-1), mag.reshape(-1, 2)).reshape(-1)
    err = (d - dp).abs()
    return float((err / (atol + rtol * s)).max()), float(err.max())


def _table_sectors(gcfg, x, n_levels: int, row_bytes: int) -> int:
    """The distinct 32-byte sectors of the table that the encode of x reads
    (corner rows of in-box points), each read once at least."""
    from monosdf_torch.ops.hashgrid import corner_geometry

    idx, _, _, inb = corner_geometry(gcfg, x, 1.0, n_levels)
    rows = idx[:, :, inb > 0]
    return int(torch.unique((rows * row_bytes) // 32).numel())


def grid_kernel_checks(dev, results):
    """Phase 3 for the grid model (bench.py --grids): K6 at the sweeps' and
    the step's shapes, K5, K7f and K7b at the step's 104,448 points, K1 at
    the grid trunk's 71-wide input, each against its plain version in
    float32 and bf16 (tables read at that dtype); times, bounds and, for
    K5, the time of one index_add_ of its per-corner terms; K6 and K5 also
    at the points of one grid training step (the ``*_rays`` fields)."""
    from monosdf_torch.cli.eval import bench_grids_config
    from monosdf_torch.kernels import hash_encode as k6
    from monosdf_torch.kernels import sdf_grad_grid as k7
    from monosdf_torch.kernels import sdf_mlp as k1
    from monosdf_torch.kernels.sdf_grad import pe_with_tangents
    from monosdf_torch.models.fields import effective_linear_weights, sweep_weights
    from monosdf_torch.ops.embedder import positional_encoding

    rng = np.random.default_rng(SEED + 4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    cfgs = {d: bench_grids_config(d) for d in ("float32", "bfloat16")}
    cfg = cfgs["bfloat16"]
    imp = cfg.implicit
    df, K = imp.divide_factor, cfg.sweep_max_level
    n_sweep = CHUNK * cfg.sampler.N_samples_eval
    N = CHUNK * cfg.sampler.total_samples + 4 * CHUNK
    L2 = imp.grid.output_dim
    model = perturbed_model(cfg, dev)
    sweeps_o, xo = grid_step_points(cfg, dev)
    ok = True
    errs = {n: {} for n in ("hash_encode_sweep", "hash_encode", "hash_encode_bwd", "sdf_grad_grid",
                            "sdf_grad_grid_bwd", "sdf_mlp_grid")}
    with torch.no_grad():
        emb = model.implicit.encoding.embeddings.reshape(-1)
        tables = {"float32": emb.contiguous(), "bfloat16": emb.to(torch.bfloat16)}
        # the scene box [-1.1, 1.1]^3 and a little beyond, as the encoder sees it (x / 1.1)
        x_sw = t(rng.uniform(-1.12, 1.12, (n_sweep, 3)))
        x = t(rng.uniform(-1.12, 1.12, (N, 3)))
        xs_sw, xs = x_sw / df, x / df
        cf, ct = t(rng.normal(size=(N, L2))), t(rng.normal(size=(3, N, L2)))
        ws, bs = effective_linear_weights(model.implicit)
        sws, sbs, packed = sweep_weights(model.implicit, imp)
        F = ws[-1].shape[1] - 1
        cots = [t(rng.normal(size=(N, k))) for k in (1, F, 3)]
        pe, pe_t = pe_with_tangents(x, imp.multires)
        pe_sw = positional_encoding(x_sw, imp.multires)

        def a0_of(feat, tg):
            return torch.cat([torch.cat([pe, feat], -1)[None],
                              torch.cat([pe_t.reshape(3, N, -1), tg], -1)], 0).contiguous()

        for dname, d in (("float32", None), ("bfloat16", torch.bfloat16)):
            g, tab = cfgs[dname].implicit.grid, tables[dname]
            f_sw = k6.hash_encode_fwd(tab, g, xs_sw, 1.0, K)
            r_sw, e_sw = _ratio([(f_sw, k6.hash_encode_fwd_plain(tab, g, xs_sw, 1.0, K))],
                                *ENCODE_TOL)
            feat, tg = k6.hash_encode_fwd(tab, g, xs, 1.0, None, True, 1.0 / df)
            fp, tp = k6.hash_encode_fwd_plain(tab, g, xs, 1.0, None, True, 1.0 / df)
            r_f, e_f = _ratio([(feat, fp), (tg, tp)], *ENCODE_TOL)
            del fp, tp
            db = k6.hash_encode_bwd(g, xs, cf, ct, 1.0, 1.0 / df)
            dbp = k6.hash_encode_bwd_plain(g, xs, cf, ct, 1.0, 1.0 / df)
            r_b, e_b = _row_ratio(db, dbp, g, xs, cf, ct, 1.0 / df, *ENCODE_BWD_TOL[dname])
            nz = int((dbp != 0).sum())
            del db, dbp
            a0 = a0_of(feat, tg)
            out = k7._forward(ws, bs, a0, d, True)
            ref = k7.sdf_mlp_with_grad_in_plain(ws, bs, a0, d, True)
            r_7f, e_7f = _ratio([*zip(out[:3], ref[:3]), *zip(out[3], ref[3])], *TOL[dname])
            zs = out[3]
            del out, ref
            dws, dbs, da0 = k7.sdf_mlp_with_grad_in_bwd(ws, bs, a0, zs, *cots, d)
            pws, pbs, pda0 = k7.sdf_mlp_with_grad_in_bwd_plain(ws, bs, a0, zs, *cots, d)
            r_7b, e_7b = _ratio(zip([*dws, *dbs, da0], [*pws, *pbs, pda0]), *GRAD_TOL[dname])
            del dws, dbs, da0, pws, pbs, pda0, zs, a0
            inp = torch.cat([pe_sw, f_sw], -1)
            r_1, e_1 = _ratio([(k1.sdf_mlp(sws, sbs, inp, (), d, packed=packed),
                                k1.sdf_mlp_plain(sws, sbs, inp, (), d))], *TOL[dname])
            for name, r, e, extra in (
                    ("hash_encode_sweep", r_sw, e_sw, f" ({K} of 16 levels)"),
                    ("hash_encode", r_f, e_f, " (features and tangents)"),
                    ("hash_encode_bwd", r_b, e_b, f" (row by row; table rows touched {nz // 2})"),
                    ("sdf_grad_grid", r_7f, e_7f, ""), ("sdf_grad_grid_bwd", r_7b, e_7b, ""),
                    ("sdf_mlp_grid", r_1, e_1, " (71-wide input)")):
                print(f"check {name:17s} {dname:8s} max_abs_err {e:.3e}; worst err / tolerance "
                      f"{r:.3e}{extra} {'ok' if r <= 1.0 else 'FAIL'}", flush=True)
                ok = ok and r <= 1.0
                errs[name][dname] = e
            del feat, tg, f_sw, inp

        # times at bf16, per launch, and the bounds of this run's inputs
        g, tab, bf = cfg.implicit.grid, tables["bfloat16"], torch.bfloat16
        feat, tg = k6.hash_encode_fwd(tab, g, xs, 1.0, None, True, 1.0 / df)
        a0 = a0_of(feat, tg)
        zs = k7._forward(ws, bs, a0, bf, True)[3]
        inp = torch.cat([pe_sw, k6.hash_encode_fwd(tab, g, xs_sw, 1.0, K)], -1)
        rows, u = k6.corner_terms(g, xs, cf, ct, 1.0, 1.0 / df)
        dlib = torch.zeros(g.table_size, 2, dtype=torch.float32, device=dev)
        timed = {
            "hash_encode": (lambda: k6.hash_encode_fwd(tab, g, xs, 1.0, None, True, 1.0 / df),
                            lambda: k6.hash_encode_fwd_plain(tab, g, xs, 1.0, None, True, 1.0 / df)),
            "hash_encode_sweep": (lambda: k6.hash_encode_fwd(tab, g, xs_sw, 1.0, K),
                                  lambda: k6.hash_encode_fwd_plain(tab, g, xs_sw, 1.0, K)),
            "hash_encode_bwd": (lambda: k6.hash_encode_bwd(g, xs, cf, ct, 1.0, 1.0 / df),
                                lambda: k6.hash_encode_bwd_plain(g, xs, cf, ct, 1.0, 1.0 / df)),
            "sdf_grad_grid": (lambda: k7._forward(ws, bs, a0, bf, True),
                              lambda: k7.sdf_mlp_with_grad_in_plain(ws, bs, a0, bf, True)),
            "sdf_grad_grid_bwd": (
                lambda: k7.sdf_mlp_with_grad_in_bwd(ws, bs, a0, zs, *cots, bf),
                lambda: k7.sdf_mlp_with_grad_in_bwd_plain(ws, bs, a0, zs, *cots, bf)),
            "sdf_mlp_grid": (lambda: k1.sdf_mlp(sws, sbs, inp, (), bf, packed=packed),
                             lambda: k1.sdf_mlp_plain(sws, sbs, inp, (), bf)),
        }
        ms = {n: (cuda_ms(kf, reps=5), cuda_ms(pf, reps=2, warmup=1)) for n, (kf, pf) in timed.items()}
        lib_ms = cuda_ms(lambda: dlib.index_add_(0, rows, u), reps=5)
        sec = _table_sectors(g, xs, g.num_levels, 4)
        sec_sw = _table_sectors(g, xs_sw, K, 4)

        # K6 and K5 at the points the model gives them, those of one grid
        # training step (grid_step_points): its sweeps' and its
        # differentiated encode's (the samples and the eikonal batch); K6
        # held to its plain version there too; wall, device (torch.profiler)
        # and host times per call, the sweeps' averaged over the step's
        No = xo.shape[0]
        cfo, cto = t(rng.normal(size=(No, L2))), t(rng.normal(size=(3, No, L2)))
        step_o = lambda: k6.hash_encode_fwd(tab, g, xo, 1.0, None, True, 1.0 / df)
        sweep_o = [lambda x_=x_, k_=k_: k6.hash_encode_fwd(tab, g, x_, 1.0, k_)
                   for x_, k_ in sweeps_o]
        bwd_o = lambda: k6.hash_encode_bwd(g, xo, cfo, cto, 1.0, 1.0 / df)
        pairs = [(f(), k6.hash_encode_fwd_plain(tab, g, x_, 1.0, k_))
                 for f, (x_, k_) in zip(sweep_o, sweeps_o)]
        pairs += zip(step_o(), k6.hash_encode_fwd_plain(tab, g, xo, 1.0, None, True, 1.0 / df))
        r_o, e_o = _ratio(pairs, *ENCODE_TOL)
        del pairs
        print(f"check hash_encode       bfloat16 max_abs_err {e_o:.3e}; worst err / tolerance "
              f"{r_o:.3e} (the grid step's points, {len(sweeps_o)} sweeps and the step) "
              f"{'ok' if r_o <= 1.0 else 'FAIL'}", flush=True)
        ok = ok and r_o <= 1.0
        mean = lambda v: sum(v) / len(v)
        rays = ("hash_encode", "hash_encode_sweep", "hash_encode_bwd")
        ms_rays = {"hash_encode": cuda_ms(step_o, reps=5),
                   "hash_encode_sweep": mean([cuda_ms(f, reps=5) for f in sweep_o]),
                   "hash_encode_bwd": cuda_ms(bwd_o, reps=5)}
        dev_ms = {"hash_encode": (device_ms(timed["hash_encode"][0], "hash_encode"),
                                  device_ms(step_o, "hash_encode")),
                  "hash_encode_sweep": (device_ms(timed["hash_encode_sweep"][0], "hash_encode"),
                                        mean([device_ms(f, "hash_encode") for f in sweep_o])),
                  "hash_encode_bwd": (device_ms(timed["hash_encode_bwd"][0], "hash_encode_bwd"),
                                      device_ms(bwd_o, "hash_encode_bwd"))}
        host = {n: host_us(timed[n][0]) for n in rays}
        # K5's yardstick at the step's points: one index_add_ of its corner
        # terms; and the device time in its call besides the kernel: the
        # memset that zeroes the gradient (kernels/hash_encode.py)
        rows_o, u_o = k6.corner_terms(g, xo, cfo, cto, 1.0, 1.0 / df)
        dlib_o = torch.zeros(g.table_size, 2, dtype=torch.float32, device=dev)
        lib_ms_rays = cuda_ms(lambda: dlib_o.index_add_(0, rows_o, u_o), reps=5)
        del rows_o, u_o, dlib_o
        prof_b = _profile(bwd_o, 5, "K5 at the grid step's points")
        memset_ms = prof_b["other_ms"]
        print(f"K5 at the grid step's points: the gradient's memset {memset_ms:.5f} device ms a "
              f"call ({json.dumps(prof_b['other_top_ms'])}), the kernel "
              f"{prof_b['kernels_ms']['hash_encode_bwd']:.5f}", flush=True)
        sec_o = _table_sectors(g, xo, g.num_levels, 4)
        sec_o_sw = [_table_sectors(g, x_, k_, 4) for x_, k_ in sweeps_o]
        sec8 = _table_sectors(g, xs, g.num_levels, 8)
        sec8_o = _table_sectors(g, xo, g.num_levels, 8)
        z_bytes, w_bytes = nbytes(*zs), nbytes(*ws, *bs)
        del rows, u, dlib, zs

    kin_l, n_l = ws[-1].shape
    k7f_flops = mlp_flops(ws[:-1], 4 * N) + 2.0 * N * kin_l * n_l + 2.0 * 3 * N * kin_l
    per_pl = 8 * (2 * 2 * 4) + 8 * 10 + 30  # 8 corners' weights, 2 channels x 4 sums, geometry
    bounds = {
        "hash_encode": bound_ms(N * 16 * per_pl, N * 12 + N * L2 * 4 * 4 + sec * 32, H100_F32_FLOPS),
        "hash_encode_sweep": bound_ms(n_sweep * K * (8 * 4 + 8 * 4 + 30),
                                      n_sweep * 12 + n_sweep * L2 * 4 + sec_sw * 32,
                                      H100_F32_FLOPS),
        "hash_encode_bwd": bound_ms(N * 16 * 8 * (2 * 4 * 2), N * 12 + N * L2 * 4 * 4
                                    + g.table_size * 2 * 4, H100_F32_FLOPS),
        "sdf_grad_grid": bound_ms(k7f_flops, nbytes(a0) + N * (4 + F * 2 + 12) + z_bytes
                                  + w_bytes, H100_BF16_FLOPS),
        "sdf_grad_grid_bwd": bound_ms(2 * k7f_flops, nbytes(a0) + z_bytes + N * (1 + F + 3) * 2
                                      + nbytes(a0) + 2 * w_bytes, H100_BF16_FLOPS),
        "sdf_mlp_grid": bound_ms(mlp_flops(sws, n_sweep), n_sweep * (inp.shape[1] * 2 + 4)
                                 + nbytes(*sws, *sbs), H100_BF16_FLOPS),
    }
    # at the grid step's points: the table sectors those points reach (K5:
    # its float32 gradient's rows, 8 bytes each); the sweeps' averaged
    sw_o = [bound_ms(len(x_) * k_ * (8 * 4 + 8 * 4 + 30),
                     len(x_) * 12 + len(x_) * L2 * 4 + n_s * 32, H100_F32_FLOPS)
            for (x_, k_), n_s in zip(sweeps_o, sec_o_sw)]
    bounds_rays = {
        "hash_encode": bound_ms(No * 16 * per_pl, No * 12 + No * L2 * 4 * 4 + sec_o * 32,
                                H100_F32_FLOPS),
        "hash_encode_sweep": (mean([b for b, _ in sw_o]), sw_o[0][1]),
        "hash_encode_bwd": bound_ms(No * 16 * 8 * (2 * 4 * 2),
                                    No * 12 + No * L2 * 4 * 4 + sec8_o * 32, H100_F32_FLOPS),
    }
    for name in ("hash_encode", "hash_encode_bwd", "sdf_grad_grid", "sdf_grad_grid_bwd"):
        (b, by), (k, pl) = bounds[name], ms[name]
        results[name] = {"max_abs_err": errs[name]["bfloat16"],
                         "max_abs_err_f32": errs[name]["float32"], "ms": k, "plain_ms": pl,
                         "bound_ms": b, "bound_by": by, "library_ms": None}
    for name, tag in (("hash_encode", ""), ("hash_encode_sweep", "_sweep"), ("hash_encode_bwd", "")):
        (b, by), (d_r, d_o) = bounds_rays[name], dev_ms[name]
        results[name.replace("_sweep", "")].update({
            f"ms{tag}_rays": ms_rays[name], f"bound_ms{tag}_rays": b, f"bound_by{tag}_rays": by,
            f"device_ms{tag}": d_r, f"device_ms{tag}_rays": d_o, f"host_us{tag}": host[name]})
    results["hash_encode"].update(table_sectors_rays=sec_o, table_sectors_sweep_rays=sec_o_sw,
                                  points_rays=No, points_sweep_rays=[len(x_) for x_, _ in sweeps_o])
    results["hash_encode_bwd"].update(table_sectors_f32=sec8, table_sectors_f32_rays=sec8_o)
    (b, by), (k, pl) = bounds["hash_encode_sweep"], ms["hash_encode_sweep"]
    results["hash_encode"].update(ms_sweep=k, plain_ms_sweep=pl, bound_ms_sweep=b,
                                  bound_by_sweep=by,
                                  max_abs_err_sweep=errs["hash_encode_sweep"]["bfloat16"],
                                  max_abs_err_sweep_f32=errs["hash_encode_sweep"]["float32"],
                                  table_sectors=sec, table_sectors_sweep=sec_sw)
    results["hash_encode_bwd"].update(library_ms=lib_ms, library_ms_rays=lib_ms_rays,
                                      memset_device_ms_rays=memset_ms)
    (b, by), (k, pl) = bounds["sdf_mlp_grid"], ms["sdf_mlp_grid"]
    results["sdf_mlp"].update(ms_grid=k, plain_ms_grid=pl, bound_ms_grid=b, bound_by_grid=by,
                              max_abs_err_grid=errs["sdf_mlp_grid"]["bfloat16"],
                              max_abs_err_grid_f32=errs["sdf_mlp_grid"]["float32"])
    print(f"grid kernels (bf16, ms per launch; library index_add_ {lib_ms:.3f} ms): "
          f"{json.dumps({n: {'ms': v[0], 'plain_ms': v[1], 'bound_ms': bounds[n][0]} for n, v in ms.items()})}",
          flush=True)
    print(f"grid kernels at the grid step's points (bf16; device ms random / step's, host us): "
          f"{json.dumps({n: {'ms_rays': ms_rays[n], 'bound_ms_rays': bounds_rays[n][0], 'device_ms': dev_ms[n], 'host_us': host[n]} for n in rays})}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    if not ok:
        fail("a grid kernel disagrees with its plain version beyond the stated tolerance")


def radiance_kernel_checks(dev, results):
    """Phase 3 for the radiance kernels at the step's 100,352 samples: K3f
    and K3b with the union model's 32-wide code operand (321-wide input),
    K8a forward and backward on its raw gradient, K8b forward and backward
    on the nerf trunk's [view PE | features] (283 wide), each against its
    plain version in float32 and bf16; times and bounds at bf16."""
    from monosdf_torch.cli.eval import union_codes_config
    from monosdf_torch.kernels import radiance_mlp as k8b
    from monosdf_torch.kernels import radiance_norm as k3
    from monosdf_torch.kernels import radiance_split as k8a
    from monosdf_torch.models.fields import effective_linear_weights
    from monosdf_torch.ops.embedder import positional_encoding

    rng = np.random.default_rng(SEED + 5)
    cfg = union_codes_config("bfloat16")
    n = CHUNK * cfg.sampler.total_samples
    F = cfg.rendering.feature_vector_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    model = perturbed_model(cfg, dev)
    with torch.no_grad():
        ws, bs = (list(x.detach() for x in xs) for xs in effective_linear_weights(model.rendering))
        g = t(rng.normal(size=(n, 3)))
        sv = torch.cat([t(rng.uniform(-1.1, 1.1, (n, 3))),
                        positional_encoding(t(rng.normal(size=(n, 3))), 4)], -1)
        feat = t(rng.normal(size=(n, F)))
        # the codes of 4 frames, as a batch's rays carry them
        code = model.rendering.embeddings.detach()[torch.from_numpy(rng.integers(0, 4, n)).to(dev)]
        co, cn = t(rng.normal(size=(n, 3))), t(rng.normal(size=(n, 3)))
        h0 = torch.cat([sv[:, 3:], feat], -1)  # nerf mode's input row without a code
        nws = [t(rng.normal(size=(h0.shape[1], ws[0].shape[1])) / np.sqrt(h0.shape[1])), *ws[1:]]
    del model

    def k3f(d, plain):
        return list((k3.radiance_norm_plain if plain else k3.radiance_norm)(ws, bs, g, sv, feat,
                                                                            d, code)), []

    def k3b(d, plain):
        fn = k3.radiance_norm_bwd_plain if plain else k3.radiance_norm_bwd
        dws, dbs, dg, df, dc = fn(ws, bs, g, sv, feat, co, cn, d, code)
        return [*dws, *dbs, dg, dc], [df]

    def k8af(d, plain):
        fn = k8a.radiance_split_plain if plain else k8a.radiance_split
        return [fn(ws, bs, g, sv, feat, code, d)], []

    def k8ab(d, plain):
        fn = k8a.radiance_split_bwd_plain if plain else k8a.radiance_split_bwd
        dws, dbs, dn, df, dc = fn(ws, bs, g, sv, feat, code, co, d)
        return [*dws, *dbs, dn, dc], [df]

    def k8bf(d, plain):
        return [(k8b.mlp_plain if plain else k8b.mlp_with_input_grad)(nws, bs, h0, d)], []

    def k8bb(d, plain):
        fn = k8b.mlp_bwd_plain if plain else k8b.mlp_with_input_grad_bwd
        dws, dbs, dh0 = fn(nws, bs, h0, co, d)
        return [*dws, *dbs, dh0], []

    # name: (function, whether its first outputs are held at GRAD_TOL (sums
    # over the rows) rather than TOL; the second list is always at TOL)
    cases = {"radiance_norm_codes": (k3f, False), "radiance_norm_bwd_codes": (k3b, True),
             "radiance_split": (k8af, False), "radiance_split_bwd": (k8ab, True),
             "radiance_mlp": (k8bf, False), "radiance_mlp_bwd": (k8bb, True)}
    ok, errs, ms = True, {}, {}
    with torch.no_grad():
        for name, (fn, grads) in cases.items():
            errs[name] = {}
            for dname, d in (("float32", None), ("bfloat16", torch.bfloat16)):
                (a, a_at_tol), (b, b_at_tol) = fn(d, False), fn(d, True)
                torch.cuda.synchronize()
                r1, e1 = _ratio(zip(a, b), *(GRAD_TOL if grads else TOL)[dname])
                r2, e2 = _ratio(zip(a_at_tol, b_at_tol), *TOL[dname])
                r, e = max(r1, r2), max(e1, e2)
                note = ""
                if name == "radiance_mlp_bwd" and d is not None:
                    # K8b's tensor-core passes sum dW in a fixed order: a
                    # second run gives the same bits
                    same = all(bits_equal(x, y) for x, y in zip(a, fn(d, False)[0]))
                    ok = ok and same
                    note = f"; a second run bit-equal {same}"
                print(f"check {name:23s} {dname:8s} max_abs_err {e:.3e}; worst err / tolerance "
                      f"{r:.3e}{note} {'ok' if r <= 1.0 else 'FAIL'}", flush=True)
                ok = ok and r <= 1.0
                errs[name][dname] = e
                del a, b, a_at_tol, b_at_tol
            bf = torch.bfloat16
            ms[name] = (cuda_ms(lambda: fn(bf, False)), cuda_ms(lambda: fn(bf, True), reps=3,
                                                                 warmup=1),
                        device_ms(lambda: fn(bf, False), name.removesuffix("_codes")))

    # bounds at bf16: FLOP and bytes (each input read once, each output
    # written once) of this run's shapes
    n0, w_bytes = ws[0].shape[1], nbytes(*ws, *bs)
    d0n = h0.shape[1]
    C = code.shape[1]

    def bwd_flops(wl, cols_out):
        # the hidden layers again, every dW, the propagation below the top,
        # and layer 0's input cotangent over the columns that have an output
        return (mlp_flops(wl[:-1], n) + mlp_flops(wl, n) + mlp_flops(wl[1:], n)
                + 2.0 * n * n0 * cols_out)

    in_k3 = n * (3 * 4 + sv.shape[1] * 2 + F * 2 + C * 4)
    in_k8a = n * (3 * 4 + sv.shape[1] * 4 + F * 2 + C * 4)
    bounds = {
        "radiance_norm_codes": bound_ms(mlp_flops(ws, n), in_k3 + n * 24 + w_bytes,
                                        H100_BF16_FLOPS),
        "radiance_norm_bwd_codes": bound_ms(bwd_flops(ws, 3 + F + C), in_k3 + n * (6 + 6)
                                            + n * (12 + F * 2 + C * 4) + 2 * w_bytes,
                                            H100_BF16_FLOPS),
        "radiance_split": bound_ms(mlp_flops(ws, n), in_k8a + n * 12 + w_bytes, H100_BF16_FLOPS),
        "radiance_split_bwd": bound_ms(bwd_flops(ws, 3 + F + C), in_k8a + n * 12
                                       + n * (12 + F * 2 + C * 4) + 2 * w_bytes,
                                       H100_BF16_FLOPS),
        "radiance_mlp": bound_ms(mlp_flops(nws, n), n * d0n * 4 + n * 12 + nbytes(*nws, *bs),
                                 H100_BF16_FLOPS),
        "radiance_mlp_bwd": bound_ms(bwd_flops(nws, d0n), n * d0n * 4 + n * 12 + n * d0n * 4
                                     + 2 * nbytes(*nws, *bs), H100_BF16_FLOPS),
    }
    for name in cases:
        (b, by), (k, pl, dk) = bounds[name], ms[name]
        entry = {"max_abs_err": errs[name]["bfloat16"], "max_abs_err_f32": errs[name]["float32"],
                 "ms": k, "device_ms": dk, "plain_ms": pl, "bound_ms": b, "bound_by": by}
        if name.endswith("_codes"):  # K3 with the code operand: beside its code-free numbers
            results[name.removesuffix("_codes")].update(
                {f"{k_}_codes": v for k_, v in entry.items()}, rows_codes=n, d0_codes=ws[0].shape[0])
        else:
            results[name] = {**entry, "library_ms": None, "rows": n,
                             "d0": d0n if name.startswith("radiance_mlp") else ws[0].shape[0]}
    print(f"radiance kernels (bf16, ms per launch): "
          f"{json.dumps({k: {'ms': v[0], 'device_ms': v[2], 'plain_ms': v[1], 'bound_ms': bounds[k][0]} for k, v in ms.items()})}",
          flush=True)
    torch.cuda.empty_cache()
    if not ok:
        fail("a radiance kernel disagrees with its plain version beyond the stated tolerance")


def path_config(which: str, dname: str):
    """The configuration of a main path's model (PATHS) at a dtype."""
    from monosdf_torch.cli.eval import bench_config, union_codes_config

    if which in ("mlp", "grids"):
        return bench_config(which == "grids", dname)
    if which == "pe":
        return dataclasses.replace(bench_config(False, dname), sweep_pe_in_kernel=True)
    cfg = union_codes_config(dname)
    return dataclasses.replace(cfg, rgb_backend="pallas") if which == "codes_split" else cfg


def chunks_of(frames, model, cfg) -> list:
    """The 1024-ray chunks of every frame, as cli/eval.py cuts them, each
    with its rays' per-image codes (None without codes)."""
    out = []
    for f in frames:
        rays = f["rays"]
        code = None
        if cfg.rendering.per_image_code:
            code = model.rendering.embeddings.detach()[f["frame_idx"]]
        for i in range(0, rays["rays_o"].shape[0], CHUNK):
            c = {k: v[i:i + CHUNK] for k, v in rays.items()}
            out.append((c, None if code is None else code[None].expand(c["rays_o"].shape[0], -1)))
    return out


def like_for_like(tag: str, dname: str, model, cfg, chunks, like: dict | None,
                  fixed: dict | None = RENDER_FIXED_MAX_ABS) -> tuple:
    """Each chunk with the kernels, then with each kernel's plain version in
    its wrapper's place, through the sampler (limits ``like``; None: not
    rendered) and at the kernel render's own samples (limits ``fixed``; None:
    the errors printed, no bar); fails past a limit.
    Prints the errors and the z_vals the plain versions' sampler moved;
    returns the kernel renders and the errors."""
    from monosdf_torch.cli.eval import OUTPUT_KEYS
    from monosdf_torch.kernels import build
    from monosdf_torch.models.monosdf import render_rays, render_samples

    outs_k = [render_rays(model, cfg, c, image_code=ic) for c, ic in chunks]
    use_plain_versions(True)
    build.reset_launch_counts()
    outs_full = ([render_rays(model, cfg, c, image_code=ic) for c, ic in chunks]
                 if like is not None else None)
    outs_fixed = [render_samples(model, cfg, c, o["z_vals"], ic)
                  for (c, ic), o in zip(chunks, outs_k)]
    use_plain_versions(False)
    if any(build.launches.values()):
        fail(f"the plain-version renders launched kernels: {build.launches}")
    errors = {}
    for what, outs_p, limits in (("fixed samples", outs_fixed, fixed),
                                 ("through the sampler", outs_full, like)):
        if outs_p is None:
            continue
        errs = {k: max(max_err(a[k], b[k])[0] for a, b in zip(outs_k, outs_p))
                for k in OUTPUT_KEYS}
        errors[what] = errs
        print(f"{tag} {dname}: kernels vs plain versions, {what}: max abs "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
              f"(limits {json.dumps(limits[dname]) if limits else 'none'})", flush=True)
        for k, limit in (limits[dname] if limits else {}).items():
            if errs[k] > limit:
                fail(f"{tag} {dname} {k}: kernels vs plain versions, {what}, max abs "
                     f"{errs[k]:.3e} > {limit}")
    if outs_full is None:
        return outs_k, errors

    z_err = max(max_err(a["z_vals"], b["z_vals"])[0] for a, b in zip(outs_k, outs_full))
    moved = sum(int(((a["z_vals"] - b["z_vals"]).abs() > 1e-4).any(-1).sum())
                for a, b in zip(outs_k, outs_full))
    print(f"{tag} {dname}: the sampler with the plain versions moved z_vals by up to "
          f"{z_err:.3e}; rays with a sample moved > 1e-4: {moved} of "
          f"{sum(c['rays_o'].shape[0] for c, _ in chunks)}", flush=True)
    return outs_k, errors


def _render_kernel_sites():
    """The eval render path's forward kernels by call site: (kernel, module,
    name, plain version); use_plain_versions swaps these among others."""
    from monosdf_torch.kernels import radiance_norm as k3
    from monosdf_torch.kernels import sampler_machinery as k4
    from monosdf_torch.kernels import sdf_grad as k2
    from monosdf_torch.kernels import sdf_mlp as k1
    from monosdf_torch.models import fields
    from monosdf_torch.ops import sampler

    return (("sdf_mlp", fields, "sdf_mlp",
             lambda *a, packed=None, **kw: k1.sdf_mlp_plain(*a, **kw)),
            ("sampler_machinery", sampler, "sampler_iter_machinery",
             k4.sampler_iter_machinery_plain),
            ("sdf_grad", k2, "_forward", k2.sdf_mlp_with_grad_plain),
            ("radiance_norm", k3, "_forward", k3.radiance_norm_plain))


def recorded_kernel_checks(tag: str, dname: str, model, cfg, chunk) -> dict:
    """Each forward kernel of the render path on the inputs a render of
    ``chunk`` gives it: every call recorded, then the plain version on the
    same arguments, at phase 3's bars (TOL per tensor; K4's beta within one
    bisection step of its bracket, its pdf entry by entry at K4_PDF_TOL).
    Fails past a bar; returns each kernel's calls and worst err / bar."""
    from monosdf_torch.models.monosdf import render_rays

    calls = {name: [] for name, *_ in _render_kernel_sites()}
    saved = []
    for name, mod, attr, _ in _render_kernel_sites():
        kernel = _KERNEL_FNS.setdefault((mod, attr), getattr(mod, attr))
        saved.append((mod, attr, getattr(mod, attr)))

        def rec(*a, _k=kernel, _n=name, **kw):
            out = _k(*a, **kw)
            calls[_n].append((a, kw, out))
            return out

        setattr(mod, attr, rec)
    try:
        with torch.no_grad():
            render_rays(model, cfg, chunk[0], image_code=chunk[1])
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    atol, rtol = TOL[dname]
    worst = {}
    plain_of = {name: plain for name, _, _, plain in _render_kernel_sites()}
    with torch.no_grad():
        for name, recs in calls.items():
            ratios = []
            for a, kw, out in recs:
                ref = plain_of[name](*a, **kw)
                outs = [out] if torch.is_tensor(out) else list(out)
                refs = [ref] if torch.is_tensor(ref) else list(ref)
                for i, (x, y) in enumerate(zip(outs, refs)):
                    if not torch.is_tensor(x):
                        continue
                    err, scale = max_err(x, y)
                    if name == "sampler_machinery" and i == 0:
                        ratios.append(err / (float(a[3].max()) / 2**10))
                    elif name == "sampler_machinery":
                        pa, pr = K4_PDF_TOL[dname]
                        ratios.append(float(((x.float() - y.float()).abs()
                                             / (pa + pr * y.float().abs())).max()))
                    else:
                        ratios.append(err / (atol + rtol * scale))
            worst[name] = {"calls": len(recs), "worst_err_over_bar": max(ratios) if ratios else None}
    print(f"{tag} {dname}: each kernel on its recorded inputs against its plain version "
          f"(phase 3's bars): {json.dumps(worst)}", flush=True)
    for name, w in worst.items():
        if not w["calls"] or w["worst_err_over_bar"] > 1.0:
            fail(f"{tag} {dname} {name}: {w} against its plain version on the recorded inputs")
    return worst


def render_phase(dev, which: str = "mlp"):
    """Phase 4 (7, 8): full-width renders of a main path's model (PATHS)
    through cli/eval.py, then chunk by chunk with the plain versions in
    place. Returns the timings and, per dtype, the model and one chunk for
    the profile phase."""
    from monosdf_torch.cli.eval import OUTPUT_KEYS, evaluate, scene_frames
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.kernels import build
    from monosdf_torch.models.monosdf import render_rays

    frames = scene_frames(make_synthetic_sphere_scene(n_images=4, img_res=64), dev)
    suffix, per_chunk, _ = PATHS[which]
    tag = "render" + suffix.replace("_", " ")
    info, runs = {}, {}
    for dname in ("bfloat16", "float32"):
        cfg = path_config(which, dname)
        model = perturbed_model(cfg, dev)
        run_frames = frames if dname == "bfloat16" else frames[:2]
        chunks = chunks_of(run_frames, model, cfg)

        # the main path: cli/eval.py's render of every view, launches counted
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        rows, outs = evaluate(model, cfg, run_frames, CHUNK)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = launch_counts()
        expect = {k: v * len(chunks) for k, v in per_chunk.items()}
        print(f"{tag} {dname}: {len(run_frames)} views, {len(chunks)} chunks in {t_k:.2f} s; "
              f"launches {counts} (expected {expect}); psnr vs gt "
              f"{[round(r[1], 2) for r in rows]}", flush=True)
        if counts != expect:
            fail(f"{tag} launch counts {counts} != {expect}")
        for i, (f, out) in enumerate(zip(run_frames, outs)):
            for key in OUTPUT_KEYS:
                n = f["rays"]["rays_o"].shape[0]
                if out[key].shape[0] != n or not torch.isfinite(out[key]).all():
                    fail(f"{tag} {dname} view {i} {key}: shape {tuple(out[key].shape)} or not finite")
        if dname == "bfloat16":
            info["launches"] = counts

        like = RENDER_LIKE_MAX_ABS_CODES if which.startswith("codes") else RENDER_LIKE_MAX_ABS
        like_for_like(tag, dname, model, cfg, chunks, like)

        # ms per 1024-ray chunk, CUDA events after a warm-up
        rays, ic = chunks[0]
        ms_k = cuda_ms(lambda: render_rays(model, cfg, rays, image_code=ic), reps=5)
        use_plain_versions(True)
        ms_p = cuda_ms(lambda: render_rays(model, cfg, rays, image_code=ic), reps=5)
        use_plain_versions(False)
        print(f"{tag} {dname}: kernels {ms_k:.3f} ms/chunk ({CHUNK / ms_k * 1e3:.1f} rays/s), "
              f"plain versions {ms_p:.3f} ms/chunk ({CHUNK / ms_p * 1e3:.1f} rays/s)", flush=True)
        info[dname] = {"ms_per_chunk": ms_k, "plain_ms_per_chunk": ms_p,
                       "rays_per_s": CHUNK / ms_k * 1e3}
        runs[dname] = (model, cfg, rays, ic)
    return info, runs


def _loss_and_grads(model, cfg, batch, z_vals, eik, loss_cfg=None):
    """The MonoSDF loss (``loss_cfg``, default ``LossConfig()``) and every
    parameter gradient at fixed samples and eikonal points (with per-image
    codes, each ray's frame's code, as the training step gathers them)."""
    from monosdf_torch.losses import LossConfig, monosdf_loss
    from monosdf_torch.models.monosdf import render_samples

    model.zero_grad(set_to_none=True)
    code = None
    if cfg.rendering.per_image_code:
        code = model.rendering.embeddings[batch["indices"]]
    out = render_samples(model, cfg, batch["rays"], z_vals, code, eik_points=eik)
    loss = monosdf_loss(loss_cfg or LossConfig(), out, batch["gt"])["loss"]
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def step_check(what: str, cfg_d, batch, dname: str, dev, loss_cfg=None):
    """Like for like at one batch: the kernel sampler's samples and eikonal
    points fixed, the loss and every gradient of a perturbed model of
    ``cfg_d`` with the kernels and with each kernel's plain version in its
    place, held at STEP_TOL[dname] (with codes, the embeddings' gradient
    rows too). Returns the check's line and the kernel run's launches."""
    from monosdf_torch.kernels import build
    from monosdf_torch.models.monosdf import sample_rays

    model_d = perturbed_model(cfg_d, dev)
    z_vals, eik = sample_rays(model_d, cfg_d, batch["rays"], True,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    build.reset_launch_counts()
    lk, gk = _loss_and_grads(model_d, cfg_d, batch, z_vals, eik, loss_cfg)
    counts_k = launch_counts()
    use_plain_versions(True)
    build.reset_launch_counts()
    lp, gp = _loss_and_grads(model_d, cfg_d, batch, z_vals, eik, loss_cfg)
    use_plain_versions(False)
    if any(build.launches.values()):
        fail(f"{what}: the plain-version step launched kernels: {build.launches}")
    atol, rtol, ltol = STEP_TOL[dname]
    worst, worst_name = 0.0, ""
    for n in gk:
        a, b = gk[n].float(), gp[n].float()
        if not torch.isfinite(a).all():
            fail(f"{what} step check {dname}: gradient {n} not finite")
        if dname == "float32":
            r = float(((a - b).abs() / (atol + rtol * b.abs())).max())
        else:
            r = float((a - b).abs().max()) / (atol + rtol * float(b.abs().max()))
        if r > worst:
            worst, worst_name = r, n
    l_ratio = abs(lk - lp) / (ltol * abs(lp) + 1e-30)
    print(f"{what} step check {dname}: loss kernels {lk:.7f} plain {lp:.7f} (diff / tolerance "
          f"{l_ratio:.3e}); worst gradient err / tolerance {worst:.3e} ({worst_name}); "
          f"launches {_nonzero(counts_k)}", flush=True)
    if worst > 1.0 or l_ratio > 1.0:
        fail(f"{what} step check {dname}: kernels vs plain versions beyond the stated "
             "tolerance")
    if cfg_d.rendering.per_image_code:
        # the rows of the batch's frames get a gradient, the others none
        frames = torch.unique(batch["indices"])
        live = gk["rendering.embeddings"].abs().amax(-1) > 0
        if len(frames) < 2 or not live[frames].all() or int(live.sum()) != len(frames):
            fail(f"{what} step check {dname}: embeddings gradient rows "
                 f"{torch.nonzero(live).flatten().tolist()} != frames {frames.tolist()}")
    del model_d, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernels": lk, "loss_plain": lp, "worst_grad_ratio": worst,
            "worst_param": worst_name}, counts_k


def train_phase(dev, which: str = "mlp"):
    """Phase 5 (7, 8): cli/train.py's step of a main path's model (PATHS)
    at full width in bf16 (warm-up, timed steps, launches per step, loss
    trajectory), the plain versions' step time, and the like-for-like step
    check in bf16 and float32 (with codes, the embeddings' gradient
    included)."""
    from monosdf_torch.cli.train import make_trainer, ray_batches
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.kernels import build
    from monosdf_torch.models.monosdf import init_monosdf

    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    batches = ray_batches(scene, np.random.default_rng(SEED), WARMUP_STEPS + TIMED_STEPS + 1,
                          CHUNK, dev)
    suffix, _, per_step = PATHS[which]
    what = "train" + suffix.replace("_", " ")
    cfg = path_config(which, "bfloat16")
    model = init_monosdf(cfg, seed=SEED, device=dev)
    step = make_trainer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b in batches[:WARMUP_STEPS]:
        step(model, b, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: TIMED_STEPS steps on distinct batches, launches counted
    build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(model, b, generator=gen)
               for b in batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    expect = {k: v * TIMED_STEPS for k, v in per_step.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    ms_step = dt / TIMED_STEPS * 1e3
    losses = [float(m["loss"]) for m in metrics]
    print(f"{what} bf16: {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up in {dt:.3f} s, "
          f"{ms_step:.3f} ms/step ({CHUNK / ms_step * 1e3:.1f} rays/s); launches {counts} "
          f"(expected {expect}); peak memory {peak_gb:.2f} GiB", flush=True)
    print(f"{what} bf16: loss {[round(v, 5) for v in losses]}", flush=True)
    print(f"{what} bf16: psnr {[round(float(m['psnr']), 3) for m in metrics]}; beta "
          f"{float(metrics[-1]['beta']):.6f}", flush=True)
    if counts != expect:
        fail(f"{what} launch counts {counts} != {expect}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: a training loss is not finite")
    for n, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all() or not torch.isfinite(p).all():
            fail(f"{what} {n}: gradient or parameter not finite after the timed steps")

    # the plain versions' step, for scale (not the main path)
    use_plain_versions(True)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    for b in batches[:2]:
        step(model, b, generator=gen)
    torch.cuda.synchronize()
    plain_ms_step = (time.perf_counter() - t0) / 2 * 1e3
    use_plain_versions(False)
    if any(build.launches.values()):
        fail(f"the plain-version steps launched kernels: {build.launches}")
    info = {"ms_per_step": ms_step, "rays_per_s": CHUNK / ms_step * 1e3, "steps": TIMED_STEPS,
            "warmup": WARMUP_STEPS, "launches": counts, "launches_per_step": per_step,
            "loss": losses, "peak_mem_gib": peak_gb, "plain_ms_per_step": plain_ms_step}
    print(f"{what} bf16: plain versions {plain_ms_step:.3f} ms/step", flush=True)

    # like for like: one batch, the kernel sampler's samples and eikonal
    # points fixed, the loss and every gradient with the kernels and with
    # each kernel's plain version in its place
    batch = batches[-1]
    for dname in ("bfloat16", "float32"):
        check, counts_k = step_check(what, path_config(which, dname), batch, dname, dev)
        # the samples are fixed: the sampler's kernels (and the sweeps' K6) do not run
        expect_k = {**per_step, **dict.fromkeys(SWEEPS, 0)}
        if which == "grids":
            expect_k["hash_encode"] -= per_step["sdf_mlp"]
        if counts_k != expect_k:
            fail(f"{what} step check launches {counts_k} != {expect_k}")
        info[f"step_check_{dname}"] = check
    return info, (model, cfg, step, batches[0], gen)


# the device functions of a kernel where they are not named <kernel>_kernel*
# (R's sum_partials_kernel: the second launch of its earlier two-launch
# form, and G's gather_smem_kernel, its earlier whole-table staging, for
# the profiles of an older checkout's kernels); reduce_partials:
# the second launch of the float32 backward kernels, counted on its own
DEVICE_NAMES = {
    "reduce_partials": ("reduce_partials",),
    "probe_gather": ("gather_l2_kernel", "gather_slice_kernel", "gather_smem_kernel",
                     "gather_ax1_kernel"),
    "probe_scatter_rows": ("scatter_rows_",),
    "probe_row_copy": ("row_copy_kernel", "sum_partials_kernel"),
    "probe_strided_permute": ("strided_permute_kernel",),
    "probe_capacity": ("capacity_kernel",),
}


def _of(kernel: str, name: str) -> bool:
    """Whether the device function ``name`` belongs to ``kernel`` (a name of
    build.SOURCES, or reduce_partials)."""
    return any(p in name for p in DEVICE_NAMES.get(kernel, (f"{kernel}_kernel",)))


def _profile(fn, reps: int, what: str) -> dict:
    """Device time per kernel over ``reps`` calls of fn (torch.profiler,
    the session's sums; ``device_ms`` reads one kernel robustly), the
    kernels' device events and launches counted meanwhile, the wall time
    per call by CUDA events, and the device's busy share."""
    from monosdf_torch.kernels import build

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):  # again where the session recorded no device event
        before = dict(build.launches)
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        # the device's own events only: an operator's entry repeats the time
        # of the kernels it launched, and a record_function range (DDP's
        # forward, Adam's step) shows on the device's timeline as a span over
        # the kernels inside it
        averages = prof.key_averages()
        ranges = {e.key for e in averages if e.device_type == torch.autograd.DeviceType.CPU}
        dev_events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.key not in ranges and not getattr(e, "is_user_annotation", False)]
        per_name = {e.key: e.self_device_time_total / 1e3 / reps for e in dev_events}  # from us
        busy = sum(per_name.values())
        if busy > 0:
            break
    else:
        fail(f"torch.profiler recorded no device time ({what})")
    ms = start.elapsed_time(end) / reps
    launched = {k: v - before[k] for k, v in build.launches.items() if v != before[k]}
    count = {e.key: e.count for e in dev_events}
    # the bf16 backward passes (*_kernel_ct, *_kernel_dw, *_kernel_sums)
    # count under their kernel
    groups = (*build.SOURCES, "reduce_partials")
    kern = {n: sum(v for k, v in per_name.items() if _of(n, k)) for n in groups}
    events = {n: sum(c for k, c in count.items() if _of(n, k)) for n in groups}
    other: dict = {}  # by the first 60 characters of the kernel's name
    for k, v in per_name.items():
        if not any(_of(n, k) for n in groups):
            other[k[:60]] = other.get(k[:60], 0.0) + v
    # the tensor-core kernels' parts: K1's, K2f's (and its render chunk's
    # CUDA-core kernel), K7f's, K3f's, K8a's and K8b's bf16 kernels, K2b's,
    # K7b's, K3b's, K8a's and K8b's two passes and their sums
    parts = ("sdf_mlp_kernel_tc", "sdf_grad_kernel_tc", "sdf_grad_kernel_fma", "sdf_grad_grid_kernel_tc",
             "radiance_norm_kernel_tc", "radiance_split_kernel_tc", "radiance_mlp_kernel_tc",
             *(f"{n}_kernel_{p}" for n in ("sdf_grad_bwd", "sdf_grad_grid_bwd", "radiance_norm_bwd",
                                           "radiance_split_bwd", "radiance_mlp_bwd")
               for p in ("ct", "dw", "sums")))
    kern_parts = {n: sum(v for k, v in per_name.items() if n in k) for n in parts}
    # the host's side: the operators' own CPU time, and the device functions
    # launched a call (each costs the host a launch)
    host = {}
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key[:60]] = host.get(e.key[:60], 0.0) + e.self_cpu_time_total / 1e3 / reps
    # the collectives' kernels (NCCL's all-reduce of a DDP step)
    nccl = [k for k in per_name if "nccl" in k.lower()]
    nccl_host = sum(e.count for e in averages
                    if e.device_type == torch.autograd.DeviceType.CPU and "nccl" in e.key.lower())
    return {"ms": ms, "device_busy_ms": busy, "busy_share": busy / ms, "kernels_ms": kern,
            "nccl_ms": sum(per_name[k] for k in nccl),
            "nccl_events": sum(count[k] for k in nccl) / reps,
            "nccl_host_events": nccl_host / reps,
            "device_events_per_call": sum(e.count for e in dev_events) / reps,
            "host_top_ms": dict(sorted(host.items(), key=lambda kv: -kv[1])[:6]),
            "kernel_events": {n: c for n, c in events.items() if c},
            "launches": launched,
            "tensor_core_parts_ms": kern_parts,
            "other_ms": busy - sum(kern.values()),
            "other_top_ms": dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])}


def profile_phase(runs, info, train_run, train_info, what: str = ""):
    """Phase 6 (7, 8): device time per kernel over PROFILE_CHUNKS renders
    of the timed chunk (for each dtype in ``runs``) and over one training
    step (torch.profiler), and the device's busy share."""
    from monosdf_torch.models.monosdf import render_rays

    for dname, (model, cfg, rays, ic) in runs.items():
        prof = _profile(lambda: render_rays(model, cfg, rays, image_code=ic), PROFILE_CHUNKS,
                        f"render{what} {dname}")
        prof["ms_per_chunk"] = prof.pop("ms")
        info[dname].update(profile=prof)
        print(f"profile{what} {dname}: {json.dumps(prof)}", flush=True)
    model, cfg, step, batch, gen = train_run
    prof = _profile(lambda: step(model, batch, generator=gen), 1, f"train{what} step")
    prof["ms_per_step"] = prof.pop("ms")
    train_info["profile"] = prof
    print(f"profile{what} train bf16: {json.dumps(prof)}", flush=True)


# the scene phase: the union model on a union scene the port generates and
# reads, 4 views of 64x64 (LDR: PNG frames; HDR: EXR frames, 3 warm-up and
# SCENE_HDR_STEPS timed steps, one view rendered)
SCENE_VIEWS, SCENE_RES, SCENE_HDR_STEPS = 4, 64, 5
# modules the port must not pull in (it depends on none; the card's machine has no jax)
FOREIGN = ("jax", "jaxlib", "monosdf_tpu", "cv2", "PIL", "matplotlib")


def scene_phase(dev):
    """Phase 9: the union-codes model (cli/eval.py union_codes_config, bf16)
    on a union scene generated by the port's generator
    (monosdf_torch/scripts/make_synthetic_scene.py: PNG frames and masks)
    into a temporary directory and loaded by data.SceneDataset (masks on, as
    confs/synth_union_quality.conf): WARMUP_STEPS warm-up and TIMED_STEPS
    timed steps of cli/train.py's step on distinct 1024-ray batches of
    ``pixel_rays()`` (launches PER_STEP a step, losses and gradients
    finite), then every view through cli/eval.py's ``evaluate`` from
    ``image_rays(i)``, each frame with its code (PER_CHUNK a chunk), each
    frame's PSNR. Then the same with ``--hdr`` (EXR frames, ``if_hdr``: the
    ReLU output and the gamma rgb loss): SCENE_HDR_STEPS timed steps and one
    view, its PSNR through the sRGB gamma. Fails where a module of FOREIGN
    was imported. Returns the ``scene`` line and the LDR model with its
    config."""
    import tempfile

    from monosdf_torch.cli.eval import dataset_frames, evaluate, union_codes_config
    from monosdf_torch.cli.train import make_trainer, ray_batches
    from monosdf_torch.data.scene_dataset import DatasetConfig, SceneDataset
    from monosdf_torch.kernels import build
    from monosdf_torch.models.monosdf import init_monosdf
    from monosdf_torch.scripts import make_synthetic_scene

    line, total = {}, dict.fromkeys(launch_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for hdr in (False, True):
            tag = "scene hdr" if hdr else "scene"
            root = os.path.join(tmp, tag.replace(" ", "_"))
            t0 = time.perf_counter()
            make_synthetic_scene.main([root, "--shape", "union", "--n", str(SCENE_VIEWS), "--res",
                                       str(SCENE_RES), *(["--hdr"] if hdr else [])])
            t_gen = time.perf_counter() - t0
            t0 = time.perf_counter()
            ds = SceneDataset(DatasetConfig(data_dir="union_scene", img_res=(SCENE_RES, SCENE_RES),
                                            data_root=root, if_hdr=hdr, use_mask=True))
            scene = ds.pixel_rays()
            t_load = time.perf_counter() - t0
            files = sorted(os.listdir(os.path.join(root, "union_scene", "Image")))
            print(f"{tag}: generated {files} in {t_gen:.3f} s, loaded {scene['rgb'].shape[0]} rays "
                  f"of {ds.n_images} views in {t_load:.3f} s; rgb {scene['rgb'].min():.3f} .. "
                  f"{scene['rgb'].max():.3f}, mask share {scene['mask'].mean():.3f}", flush=True)
            ext = ".exr" if hdr else ".png"
            if len(files) != SCENE_VIEWS or not all(f.endswith(ext) for f in files):
                fail(f"{tag}: the generator wrote {files}, not {SCENE_VIEWS} {ext} frames")
            if not np.isfinite(scene["rgb"]).all() or (scene["rgb"].max() > 1.0) != hdr:
                fail(f"{tag}: rgb not finite, or its range {scene['rgb'].max()} does not fit "
                     f"{'HDR' if hdr else 'LDR'} frames")

            cfg = union_codes_config("bfloat16")
            if hdr:
                cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering,
                                                                             if_hdr=True))
            timed = SCENE_HDR_STEPS if hdr else TIMED_STEPS
            model = init_monosdf(cfg, seed=SEED, device=dev)
            step = make_trainer(model, cfg)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            batches = ray_batches(scene, np.random.default_rng(SEED), WARMUP_STEPS + timed, CHUNK,
                                  dev)
            for b in batches[:WARMUP_STEPS]:
                step(model, b, generator=gen)
            torch.cuda.synchronize()
            # the main path: timed steps on distinct batches, launches counted
            build.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = [step(model, b, generator=gen) for b in batches[WARMUP_STEPS:]]
            torch.cuda.synchronize()
            ms_step = (time.perf_counter() - t0) / timed * 1e3
            counts = launch_counts()
            expect = {k: v * timed for k, v in PER_STEP.items()}
            losses = [float(m["loss"]) for m in metrics]
            print(f"{tag} train bf16: {timed} steps after {WARMUP_STEPS} warm-up, {ms_step:.3f} "
                  f"ms/step ({CHUNK / ms_step * 1e3:.1f} rays/s); launches {_nonzero(counts)} "
                  f"(expected {_nonzero(expect)}); loss {[round(v, 5) for v in losses]}; psnr "
                  f"{[round(float(m['psnr']), 3) for m in metrics]}", flush=True)
            if counts != expect:
                fail(f"{tag} train launch counts {counts} != {expect}")
            if not all(math.isfinite(v) for v in losses):
                fail(f"{tag}: a training loss is not finite")
            for n, p in model.named_parameters():
                if p.grad is None or not torch.isfinite(p.grad).all() or not torch.isfinite(p).all():
                    fail(f"{tag} {n}: gradient or parameter not finite after the timed steps")
            for k, v in counts.items():
                total[k] += v

            frames = dataset_frames(ds, dev)[:1 if hdr else None]
            chunks = sum(-(-f["rays"]["rays_o"].shape[0] // CHUNK) for f in frames)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            rows, outs = evaluate(model, cfg, frames, CHUNK)
            torch.cuda.synchronize()
            t_render = time.perf_counter() - t0
            counts = launch_counts()
            expect = {k: v * chunks for k, v in PER_CHUNK.items()}
            psnrs = [r[1] for r in rows]
            print(f"{tag} render bf16: {len(frames)} views, {chunks} chunks in {t_render:.3f} s; "
                  f"launches {_nonzero(counts)} (expected {_nonzero(expect)}); psnr vs gt "
                  f"{'through the sRGB gamma ' if hdr else ''}{[round(v, 3) for v in psnrs]}",
                  flush=True)
            if counts != expect:
                fail(f"{tag} render launch counts {counts} != {expect}")
            for f, out in zip(frames, outs):
                n = f["rays"]["rays_o"].shape[0]
                if any(out[k].shape[0] != n or not torch.isfinite(out[k]).all() for k in out):
                    fail(f"{tag} view {f['frame_idx']}: a render output of the wrong shape or "
                         "not finite")
            if not all(math.isfinite(v) for v in psnrs):
                fail(f"{tag}: a PSNR is not finite")
            for k, v in counts.items():
                total[k] += v
            line["hdr" if hdr else "ldr"] = {
                "views": ds.n_images, "img_res": [SCENE_RES, SCENE_RES], "generate_s": t_gen,
                "load_s": t_load, "steps": timed, "warmup": WARMUP_STEPS, "ms_per_step": ms_step,
                "rays_per_s": CHUNK / ms_step * 1e3, "loss": losses, "render_views": len(frames),
                "render_chunks": chunks, "render_s": t_render, "psnr": psnrs,
                "psnr_through_gamma": hdr}
            if not hdr:
                kept = (model, cfg)  # the mesh phase meshes the LDR model
            del model, step, batches
            torch.cuda.empty_cache()
    foreign = sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
    print(f"scene: modules of {list(FOREIGN)} imported: {foreign}", flush=True)
    if foreign:
        fail(f"the scene phase imported {foreign}")
    line["launches"] = total
    return line, kept


# the mesh phase: the export of monosdf_tpu/train/trainer.py export_mesh at
# the schema's plot_resolution and grid_boundary (monosdf_tpu/config/
# schema.py:32-33, confs/synth_union_quality.conf:19) in crops of 128; the
# grid model at MESH_RES_GRID
MESH_RES, MESH_RES_GRID, MESH_CROP, MESH_BOUNDARY = 512, 256, 128, (-1.1, 1.1)
# kernel mesh vs the plain versions' mesh: face counts within MESH_FACES_RTOL,
# the symmetric mean nearest-vertex distance within MESH_VERT_CELLS cells
MESH_FACES_RTOL, MESH_VERT_CELLS = 1e-3, 1e-2
# the analytic union surface's mesh: every vertex within this many cells of
# the zero set (linear interpolation along a tet edge errs by ~h^2 k / 8)
MESH_ANALYTIC_CELLS = 0.1
# surface samples of each mesh for mesh_metrics_3d (the Replica protocol's
# 200,000 cut to 20,000: the KD-tree queries between two meshes ~0.1 apart
# took 129 s of the card host's time at 200,000)
MESH_METRIC_SAMPLES = 20_000


def _counted(sdf_fn):
    """sdf_fn with a count of its calls (``.calls[0]``) and its device."""
    calls = [0]

    def fn(pts):
        calls[0] += 1
        return sdf_fn(pts)

    fn.calls, fn.device = calls, getattr(sdf_fn, "device", None)
    return fn


def _vertex_dist(a, b) -> float:
    """The symmetric mean nearest-vertex distance of two vertex sets."""
    from scipy.spatial import cKDTree

    return 0.5 * float(cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def _mesh_model(dev, model, cfg, res: int, tag: str, tmp: str, per_call: dict):
    """One model's mesh: extract_mesh of mesh_sdf_fn at ``res`` in crops of
    MESH_CROP, launches counted from 0 (``per_call``: each kernel's launches
    a call of the SDF callable); the PLY written and read back; the same
    extraction with each kernel's plain version in its wrapper's place
    (faces, vertices); one dense crop's SDF grid both ways at K1's float32
    bar, and a control: the plain grid moved by that bar, marched, shows
    the vertex-distance bar would catch a kernel wrong by it. Returns
    (the info, the launches, verts, faces)."""
    from monosdf_torch.kernels import build
    from monosdf_torch.kernels import sdf_mlp as k1
    from monosdf_torch.meshing import extract_mesh, mesh_sdf_fn, read_ply, write_ply
    from monosdf_torch.meshing.extract import sdf_grid_eval
    from monosdf_torch.models import fields
    from monosdf_torch.native import lib_path, marching_tetrahedra_native
    from monosdf_torch.ops.embedder import positional_encoding

    h = (MESH_BOUNDARY[1] - MESH_BOUNDARY[0]) / res
    kw = dict(resolution=res, grid_boundary=MESH_BOUNDARY, crop_n=MESH_CROP)
    sdf = _counted(mesh_sdf_fn(model, cfg))
    torch.cuda.synchronize()
    build.reset_launch_counts()
    stats, t0 = {}, time.perf_counter()
    verts, faces = extract_mesh(sdf, stats=stats, **kw)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    counts, calls = launch_counts(), sdf.calls[0]
    expect = {k: v * calls for k, v in {**_NONE, **per_call}.items()}
    path = os.path.join(tmp, f"surface_{tag}_{res}.ply")
    t0 = time.perf_counter()
    write_ply(path, verts, faces)
    t_ply = time.perf_counter() - t0
    v_back, f_back = read_ply(path)
    print(f"mesh {tag}: {res} in crops of {MESH_CROP}, {calls} calls of the SDF, launches "
          f"{_nonzero(counts)} (expected {_nonzero(expect)}); {stats['points']} points "
          f"({stats['points'] / (res + 1) ** 3:.4f} of the dense {res + 1}^3) in "
          f"{stats['eval_s']:.3f} s, marched ({stats['marcher']}) in {stats['march_s']:.3f} s, "
          f"{len(verts)} verts, {len(faces)} faces; PLY {os.path.getsize(path)} bytes in "
          f"{t_ply:.3f} s", flush=True)
    if counts != expect:
        fail(f"mesh {tag}: launch counts {counts} != {expect}")
    if not len(faces) or not np.isfinite(verts).all() or faces.max() >= len(verts):
        fail(f"mesh {tag}: an empty mesh, a vertex not finite or a face off the vertices")
    if not (np.array_equal(v_back, verts) and np.array_equal(f_back, faces)):
        fail(f"mesh {tag}: the PLY does not read back")

    use_plain_versions(True)
    try:
        plain_stats = {}
        vp, fp = extract_mesh(sdf, stats=plain_stats, **kw)
    finally:
        use_plain_versions(False)
    faces_rel = abs(len(faces) - len(fp)) / len(fp)
    dist_cells = _vertex_dist(verts, vp) / h

    # one dense crop through the surface: the crop holding the grid's point nearest
    # to the first vertex
    per = res // max(1, -(-res // MESH_CROP))
    coords = np.linspace(*MESH_BOUNDARY, res + 1, dtype=np.float32)
    lo = [int(np.clip((c - MESH_BOUNDARY[0]) / h, 0, res - 1)) // per * per for c in verts[0]]
    axes = [coords[i:i + per + 1] for i in lo]
    grid_k = sdf_grid_eval(sdf, *axes)
    use_plain_versions(True)
    try:
        grid_p = sdf_grid_eval(sdf, *axes)
    finally:
        use_plain_versions(False)
    atol, rtol = TOL["float32"]
    bar = atol + rtol * float(np.abs(grid_p).max())
    err = float(np.abs(grid_k - grid_p).max())
    origin, spacing = np.array([a[0] for a in axes], np.float32), np.float32(h)
    (vk, fk), (vq, fq) = (marching_tetrahedra_native(g, origin, spacing)
                          for g in (grid_k, grid_p))
    vc, fc = marching_tetrahedra_native(grid_p + np.float32(bar), origin, spacing)
    crop = {"lo": lo, "points": int(grid_k.size), "max_abs_err": err, "bar": bar,
            "vertex_dist_cells": _vertex_dist(vk, vq) / h,
            "faces_rel_diff": abs(len(fk) - len(fq)) / max(len(fq), 1),
            "control_vertex_dist_cells": _vertex_dist(vc, vq) / h,
            "control_faces_rel_diff": abs(len(fc) - len(fq)) / max(len(fq), 1)}
    print(f"mesh {tag} vs plain versions: faces {len(faces)} / {len(fp)} (rel diff "
          f"{faces_rel:.2e}, bar {MESH_FACES_RTOL}); vertex distance {dist_cells:.3e} cells (bar "
          f"{MESH_VERT_CELLS}); dense crop at {lo}: max abs err {err:.3e} (bar {bar:.3e}), "
          f"vertex distance {crop['vertex_dist_cells']:.3e} cells; a grid off by the bar: "
          f"{crop['control_vertex_dist_cells']:.3e} cells, faces rel diff "
          f"{crop['control_faces_rel_diff']:.2e}", flush=True)
    if (faces_rel > MESH_FACES_RTOL or dist_cells > MESH_VERT_CELLS or err > bar
            or crop["control_vertex_dist_cells"] <= MESH_VERT_CELLS):
        fail(f"mesh {tag}: the kernel mesh misses the plain versions' (or the vertex bar would "
             "not catch a grid off by K1's float32 bar)")

    # K1 alone on one chunk of the crop's points, float32 (the mesh's K1 call)
    pts = torch.from_numpy(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)[:131072]
                           ).to(dev)
    with torch.no_grad():
        ws, bs, packed = fields.sweep_weights(model.implicit, cfg.implicit)
        inp = positional_encoding(pts, cfg.implicit.multires)
        if cfg.implicit.use_grid:
            inp = torch.cat([inp, fields._grid_features(model.implicit, cfg.implicit, pts,
                                                        fields.grid_table(model.implicit,
                                                                          cfg.implicit))], -1)
        skip = tuple(cfg.implicit.skip_in)
        out = k1.sdf_mlp(ws, bs, inp, skip, None, packed)
        k1_ms = cuda_ms(lambda: k1.sdf_mlp(ws, bs, inp, skip, None, packed))
        k1_plain_ms = cuda_ms(lambda: k1.sdf_mlp_plain(ws, bs, inp, skip, None))
    k1_bound, k1_by = bound_ms(mlp_flops(ws, inp.shape[0]),
                               nbytes(inp, out, *ws, *bs), H100_F32_FLOPS)
    info = {
        "resolution": res, "crop_n": MESH_CROP, "grid_boundary": list(MESH_BOUNDARY),
        "cell": h, "marcher": stats["marcher"], "native_library": lib_path().name,
        "sdf_calls": calls, "launches": _nonzero(counts), "points": stats["points"],
        "points_dense": (res + 1) ** 3, "points_share": stats["points"] / (res + 1) ** 3,
        "crops": stats["crops"], "crops_marched": stats["crops_marched"],
        "eval_s": stats["eval_s"], "march_s": stats["march_s"], "extract_s": t_extract,
        "verts": len(verts), "faces": len(faces), "ply_bytes": os.path.getsize(path),
        "ply_write_s": t_ply,
        "plain": {"verts": len(vp), "faces": len(fp), "eval_s": plain_stats["eval_s"],
                  "march_s": plain_stats["march_s"]},
        "faces_rel_diff": faces_rel, "faces_bar": MESH_FACES_RTOL,
        "vertex_dist_cells": dist_cells, "vertex_dist_bar_cells": MESH_VERT_CELLS,
        "dense_crop": crop,
        "k1_float32_chunk": {"points": inp.shape[0], "d0": inp.shape[1], "ms": k1_ms,
                             "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by},
    }
    return info, counts, verts, faces


def mesh_phase(dev, union_model, union_cfg):
    """Phase 10: meshes through cli/eval.py's export (meshing.extract_mesh on
    meshing.mesh_sdf_fn, the native marcher): the union-codes model phase 9
    trained on the union scene at MESH_RES over MESH_BOUNDARY in crops of
    MESH_CROP (the pyramid; the grid SDF through K1 at float32, one launch a
    call of the SDF callable, K2f's and K4's order references 0), and the
    grid model (bench_grids_config, seeded init plus the smoke's
    perturbation) at MESH_RES_GRID (K6 and K1, one launch each a call); each
    against the same extraction with the plain versions (_mesh_model); then
    the union scene's analytic SDF (make_synthetic_scene.union_sdf_torch on
    the card) meshed at MESH_RES, every vertex within MESH_ANALYTIC_CELLS
    cells of the zero set, and Chamfer, F-score at 0.05 and normal
    consistency of the union model's mesh against it (mesh_metrics_3d on
    MESH_METRIC_SAMPLES samples a mesh; no bar). Fails where a module of
    FOREIGN was imported. Returns the ``mesh`` line."""
    import tempfile

    from monosdf_torch.cli.eval import bench_grids_config
    from monosdf_torch.eval.metrics import mesh_metrics_3d
    from monosdf_torch.meshing import extract_mesh
    from monosdf_torch.native import get_native_lib
    from monosdf_torch.scripts.make_synthetic_scene import union_sdf, union_sdf_torch

    t_phase = time.perf_counter()
    line, total = {}, dict.fromkeys(launch_counts(), 0)
    # the native marcher is built (g++) before the timed extractions
    t0 = time.perf_counter()
    get_native_lib()
    line["native_build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        line["union"], counts, verts, faces = _mesh_model(dev, union_model, union_cfg, MESH_RES,
                                                          "union", tmp, {"sdf_mlp": 1})
        for k, v in counts.items():
            total[k] += v
        gcfg = bench_grids_config("bfloat16")
        gmodel = perturbed_model(gcfg, dev)
        line["grid"], counts, _, _ = _mesh_model(dev, gmodel, gcfg, MESH_RES_GRID, "grid", tmp,
                                                 {"sdf_mlp": 1, "hash_encode": 1})
        for k, v in counts.items():
            total[k] += v
        del gmodel
        torch.cuda.empty_cache()

    def analytic(pts):
        return union_sdf_torch(pts)

    stats, h = {}, (MESH_BOUNDARY[1] - MESH_BOUNDARY[0]) / MESH_RES
    vg, fg = extract_mesh(analytic, resolution=MESH_RES, grid_boundary=MESH_BOUNDARY,
                          crop_n=MESH_CROP, device=dev, stats=stats)
    worst = float(np.abs(union_sdf(vg.astype(np.float64))).max()) / h
    t0 = time.perf_counter()
    metrics = mesh_metrics_3d(verts, faces, vg, fg, n_samples=MESH_METRIC_SAMPLES,
                              threshold=0.05)
    t_metrics = time.perf_counter() - t0
    line["analytic"] = {"resolution": MESH_RES, "verts": len(vg), "faces": len(fg),
                        "points": stats["points"], "eval_s": stats["eval_s"],
                        "march_s": stats["march_s"], "max_abs_sdf_cells": worst,
                        "bar_cells": MESH_ANALYTIC_CELLS}
    line["union"]["vs_analytic"] = {**metrics, "threshold": 0.05, "samples": MESH_METRIC_SAMPLES,
                                    "seconds": t_metrics}
    print(f"mesh analytic union: {len(vg)} verts, {len(fg)} faces, max |union_sdf(v)| "
          f"{worst:.3e} cells (bar {MESH_ANALYTIC_CELLS}); the union model's mesh against it: "
          f"chamfer {metrics['chamfer']:.5f}, F-score@0.05 {metrics['f_score']:.4f}, normal "
          f"consistency {metrics['normal_consistency']:.4f} (no bar) in {t_metrics:.2f} s",
          flush=True)
    if worst > MESH_ANALYTIC_CELLS or not len(fg):
        fail("mesh analytic: a vertex lies off the union scene's zero set")
    foreign = sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
    print(f"mesh: modules of {list(FOREIGN)} imported: {foreign}; the native marcher built in "
          f"{line['native_build_s']:.2f} s; the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if foreign:
        fail(f"the mesh phase imported {foreign}")
    line["seconds"] = time.perf_counter() - t_phase
    line["launches"] = total
    return line


# the conf phase: three shipped confs through cli/train.py --conf and
# cli/eval.py --conf, each on a scene the port's generator writes at the
# confs' 96x96 (4 views: 3 train frames of 9216 rays, 27 steps an epoch at
# 1024 rays); the overlay cuts only the run length, so that the union run's
# resume crosses one epoch (a checkpoint and a validation plot at step 27)
CONF_VIEWS, CONF_RES = 4, 96
CONF_OVERLAY = "train{ max_total_iters = 30, checkpoint_freq = 1, plot_freq = 1 }\n"
# line -> (conf, generator arguments, steps of the first run, resumed to the
# overlay's max_total_iters)
CONF_RUNS = {
    "conf": ("confs/synth_union_quality.conf", ["--shape", "union"], 20, True),
    "conf_grids": ("confs/synth_sphere_quality_grids.conf", ["--shape", "sphere"], 10, False),
    "conf_hdr": ("confs/synth_union_hdr.conf", ["--shape", "union", "--hdr"], 10, False),
}
CONF_TIMED_STEPS = 10
CONF_ROUNDS = 2  # of the Trainer's step and of the pre-built batches' step, in turns
CONF_PROFILE_STEPS = 3
CONF_SDF_GRID = 65  # points a side: the SDF's least value over the mesh box
CONF_EVAL_RES = 512  # cli/eval.py's default mesh resolution
# the kernels the training step runs at fixed samples (step_check), per conf line
CONF_STEP_KERNELS = {
    "conf": ("sdf_grad", "sdf_grad_bwd", "radiance_norm", "radiance_norm_bwd"),
    "conf_grids": ("hash_encode", "sdf_grad_grid", "sdf_grad_grid_bwd", "hash_encode_bwd"),
}


def conf_phase(dev):
    """Phase 11: the conf path, through the entry points a user calls. For
    each of CONF_RUNS: a scene from monosdf_torch/scripts/
    make_synthetic_scene.py, then ``cli.train.main(["--conf", conf,
    "--conf_add", overlay, ...])`` (a Trainer: steps, checkpoints,
    metrics, validation plots, the closing validation and mesh) and, for
    the union conf, a second call with ``--resume`` that continues from
    step 20 to 30; then ``cli.eval.main(["--conf", ..., "--checkpoint_dir",
    ..., "--eval_rendering"])``. Launches are counted over those calls: every
    kernel of ``config.routed_kernels`` launched, no other. The union run
    keeps at most 3 numbered checkpoints, its metrics rows show the resume
    at 20, and its plot directory holds the epoch-1 dashboards and
    surface_1.ply; the grid conf's encoding group runs at 1.0x the base
    rate (its conf's factor); the HDR conf renders finite rgb_spec_values
    and runs no K3; the closing mesh and cli/eval.py's have vertices (the
    HDR conf's where its SDF is negative anywhere on a CONF_SDF_GRID^3
    grid over the mesh box: after 10 steps it may be positive everywhere,
    as the JAX package's, PERF.md PR 17). Then,
    off the counted runs: CONF_ROUNDS rounds of CONF_TIMED_STEPS steps of
    the trainer's step after 3 warm-up (ms a step, rays/s), in turns with
    the same step on batches sampled beforehand, the host batch alone, a
    torch.profiler profile of CONF_PROFILE_STEPS steps of each kind (busy
    share, kernels, the other device work), a checkpoint's write and read
    (seconds, bytes), a validation plot's and a mesh's seconds, and
    at the union and grid confs the step check (kernels against plain
    versions at fixed samples, bf16 bars). Fails where a module of FOREIGN
    was imported. Returns the three ``conf`` lines."""
    import tempfile

    from monosdf_torch.cli import eval as ceval
    from monosdf_torch.cli import train as ctrain
    from monosdf_torch.config import routed_kernels
    from monosdf_torch.kernels import build
    from monosdf_torch.meshing import mesh_sdf_fn, read_ply
    from monosdf_torch.models.monosdf import render_rays
    from monosdf_torch.scripts import make_synthetic_scene
    from monosdf_torch.train.checkpoint import load_checkpoint, restore_state, save_checkpoint

    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        overlay = os.path.join(tmp, "run_length.conf")
        with open(overlay, "w") as f:
            f.write(CONF_OVERLAY)
        for tag, (conf_rel, gen_args, first, resume) in CONF_RUNS.items():
            what = tag.replace("_", " ")
            conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), conf_rel)
            root = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            make_synthetic_scene.main([root, "--n", str(CONF_VIEWS), "--res", str(CONF_RES),
                                       *gen_args])
            t_gen = time.perf_counter() - t0
            exps = os.path.join(tmp, f"exps_{tag}")
            args = ["--conf", conf, "--conf_add", overlay, "--data_root", root,
                    "--exps_root", exps, "--device", str(dev), "--timestamp", "smoke"]
            # the main path: the CLI runs, launches counted from 0
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = ctrain.main(args + ["--max_iters", str(first)])
            t_train = time.perf_counter() - t0
            if trainer.step != first:
                fail(f"{what}: the first run stopped at step {trainer.step}, not {first}")
            t_resume = None
            if resume:
                t0 = time.perf_counter()
                trainer = ctrain.main(args[:-2] + ["--resume"])
                t_resume = time.perf_counter() - t0
            cfg, exp = trainer.exp.model, trainer.exp
            out_dir = os.path.join(tmp, f"eval_{tag}")
            t0 = time.perf_counter()
            rows = ceval.main(["--conf", conf, "--conf_add", overlay, "--data_root", root,
                               "--checkpoint_dir", trainer.ckpt_dir, "--eval_rendering",
                               "--device", str(dev), "--resolution", str(CONF_EVAL_RES),
                               "--out_dir", out_dir])
            torch.cuda.synchronize()
            t_eval = time.perf_counter() - t0
            counts = launch_counts()
            routed = set(routed_kernels(cfg))
            launched = set(_nonzero(counts))
            print(f"{what}: {conf} trained {trainer.step} steps in {t_train:.3f} s"
                  f"{f' (resumed to {trainer.step} in {t_resume:.3f} s)' if resume else ''}, "
                  f"cli/eval.py {t_eval:.3f} s; launches {_nonzero(counts)}; routed "
                  f"{sorted(routed)}", flush=True)
            if launched != routed:
                fail(f"{what}: launched {sorted(launched)}, the routing rule names "
                     f"{sorted(routed)}")

            # the run's files
            rows_m = [json.loads(l) for l in open(os.path.join(trainer.run_dir, "metrics.jsonl"))]
            numbered = [f for f in os.listdir(trainer.ckpt_dir)
                        if f.endswith(".ckpt") and f[:-5].isdigit()]
            plots = sorted(os.listdir(trainer.plot_dir))
            losses = [r["loss"] for r in rows_m]
            psnr = [r[1] for r in rows]
            print(f"{what}: metrics iters {[r['iter'] for r in rows_m]} loss "
                  f"{[round(v, 5) for v in losses]}; checkpoints {sorted(os.listdir(trainer.ckpt_dir))}; "
                  f"plots {plots}; eval psnr {psnr} ({sorted(os.listdir(out_dir))})", flush=True)
            if not all(math.isfinite(v) for v in losses + psnr) or not rows_m:
                fail(f"{what}: a logged loss or an eval PSNR is not finite")
            if len(numbered) > 3 or "latest.ckpt" not in os.listdir(trainer.ckpt_dir):
                fail(f"{what}: checkpoints {numbered} (at most 3 numbered, and latest.ckpt)")
            if not {"psnr.csv", f"surface_{CONF_EVAL_RES}.ply"} <= set(os.listdir(out_dir)):
                fail(f"{what}: cli/eval.py wrote {os.listdir(out_dir)}")
            if f"surface_{trainer.step}.ply" not in plots:
                fail(f"{what}: no closing mesh surface_{trainer.step}.ply in {plots}")
            # the closing mesh (at the plot resolution) and cli/eval.py's hold
            # a surface; only an SDF with no negative value meshes to nothing,
            # and only the HDR conf's may have none so early (PERF.md, PR 17)
            mesh_verts = {
                "closing": len(read_ply(os.path.join(trainer.plot_dir,
                                                     f"surface_{trainer.step}.ply"))[0]),
                "eval": len(read_ply(os.path.join(out_dir, f"surface_{CONF_EVAL_RES}.ply"))[0])}
            lo, hi = exp.grid_boundary
            axis = torch.linspace(lo, hi, CONF_SDF_GRID, device=dev)
            with torch.no_grad():
                sdf_min = float(mesh_sdf_fn(trainer.model, cfg)(
                    torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
                    .reshape(-1, 3)).min())
            print(f"{what}: mesh vertices {mesh_verts}; the SDF's least value on a "
                  f"{CONF_SDF_GRID}^3 grid {sdf_min:.5f}", flush=True)
            if not all(mesh_verts.values()) and (tag != "conf_hdr" or sdf_min < 0):
                fail(f"{what}: an empty mesh ({mesh_verts} vertices; the SDF's least value "
                     f"{sdf_min:.5f})")
            if resume:
                frame = trainer.val_images[0]["frame_idx"]
                want = {"surface_1.ply", *(f"VAL_{n}_1_{frame}.png"
                                           for n in ("rendering", "depth", "normal", "merge"))}
                if [r["iter"] for r in rows_m] != [1, first + 1] or not want <= set(plots):
                    fail(f"{what}: the resume did not continue from {first}, or the epoch-1 "
                         f"plot is missing ({sorted(want - set(plots))})")
            if cfg.implicit.use_grid:
                lr_of = {id(p): g["lr"] for g in trainer.optimizer.adam.param_groups
                         for p in g["params"]}
                imp = trainer.model.implicit
                lr_enc, lr_net = lr_of[id(imp.encoding.embeddings)], lr_of[id(imp.lin0.b)]
                ratio = lr_enc / lr_net
                print(f"{what}: encoding group lr {lr_enc:.6e}, {ratio} x the base rate "
                      f"(conf factor {exp.optim.lr_factor_for_grid})", flush=True)
                if ratio != 1.0:
                    fail(f"{what}: the encoding group's rate is {ratio} x the base rate, not 1.0")
            if cfg.rendering.spec:
                img = trainer.val_images[0]
                rays = {k: torch.from_numpy(np.ascontiguousarray(v[:CHUNK])).to(dev)
                        for k, v in img["rays"].items()}
                code = trainer.model.rendering.embeddings.detach()[img["frame_idx"]]
                out = render_rays(trainer.model, cfg, rays,
                                  image_code=code[None].expand(rays["rays_o"].shape[0], -1))
                spec = out.get("rgb_spec_values")
                print(f"{what}: rgb_spec_values max {None if spec is None else float(spec.max())}, "
                      f"rgb_values max {float(out['rgb_values'].max()):.4f}", flush=True)
                if spec is None or not all(torch.isfinite(v).all() for v in out.values()):
                    fail(f"{what}: no rgb_spec_values, or a render output not finite")

            # off the counted runs: the step's time, a checkpoint, a plot, a mesh
            steps_run, step, gen = trainer.step, trainer.step_fn, trainer.generator
            n_rays = exp.num_pixels
            host_step = lambda: step(trainer.model, trainer.sample_batch(n_rays), generator=gen)
            for _ in range(WARMUP_STEPS):
                host_step()
            # the Trainer's step (its batch sampled on the host each step) and
            # the same step on batches sampled beforehand, in turns; then the
            # host batch alone
            pre = [trainer.sample_batch(n_rays) for _ in range(CONF_TIMED_STEPS)]
            pre_cycle = itertools.cycle(pre)
            pre_step = lambda: step(trainer.model, next(pre_cycle), generator=gen)
            rounds = {"trainer": [], "prebuilt": []}
            for _ in range(CONF_ROUNDS):
                for kind, fn in (("trainer", host_step), ("prebuilt", pre_step)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(CONF_TIMED_STEPS):
                        m = fn()
                    torch.cuda.synchronize()
                    rounds[kind].append((time.perf_counter() - t0) / CONF_TIMED_STEPS * 1e3)
                    if not math.isfinite(float(m["loss"])):
                        fail(f"{what}: a timed step's loss is not finite")
            ms_step = rounds["trainer"][0]
            t0 = time.perf_counter()
            for _ in range(CONF_TIMED_STEPS):
                trainer.sample_batch(n_rays)
            torch.cuda.synchronize()
            ms_batch = (time.perf_counter() - t0) / CONF_TIMED_STEPS * 1e3
            # where the time goes: torch.profiler over both kinds of step
            profiles = {}
            for kind, fn in (("trainer", host_step), ("prebuilt", pre_step)):
                prof = _profile(fn, CONF_PROFILE_STEPS, f"{what} {kind} step")
                profiles[kind] = {
                    "ms_per_step": prof["ms"], "device_busy_ms": prof["device_busy_ms"],
                    "busy_share": prof["busy_share"],
                    "kernels_ms": {k: v for k, v in prof["kernels_ms"].items() if v},
                    "other_ms": prof["other_ms"], "other_top_ms": prof["other_top_ms"],
                    "device_events_per_step": prof["device_events_per_call"],
                    "host_top_ms": prof["host_top_ms"]}
            print(f"{what} bf16 steps (ms, {CONF_ROUNDS} rounds of {CONF_TIMED_STEPS} in turns): "
                  f"trainer {[round(v, 3) for v in rounds['trainer']]}, pre-built batches "
                  f"{[round(v, 3) for v in rounds['prebuilt']]}; the host batch alone "
                  f"{ms_batch:.3f}; profiles of {CONF_PROFILE_STEPS}: {json.dumps(profiles)}",
                  flush=True)
            ck = os.path.join(tmp, f"ckpt_{tag}")
            t0 = time.perf_counter()
            path = save_checkpoint(ck, trainer.model, trainer.optimizer, 99)
            t_write = time.perf_counter() - t0
            ck_bytes = os.path.getsize(path)
            t0 = time.perf_counter()
            restore_state(trainer.model, trainer.optimizer, load_checkpoint(ck), strict=True)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            t0 = time.perf_counter()
            trainer.plot_validation(99)
            torch.cuda.synchronize()
            t_plot = time.perf_counter() - t0
            t0 = time.perf_counter()
            trainer.export_mesh(path=os.path.join(tmp, f"mesh_{tag}.ply"))
            t_mesh = time.perf_counter() - t0
            print(f"{what} bf16: {ms_step:.3f} ms/step ({exp.num_pixels / ms_step * 1e3:.1f} "
                  f"rays/s) over {CONF_TIMED_STEPS} steps after {WARMUP_STEPS} warm-up; checkpoint "
                  f"write {t_write:.3f} s, read {t_read:.3f} s, {ck_bytes} bytes; validation plot "
                  f"{t_plot:.3f} s (mesh at {exp.plot_resolution} and dashboards), mesh "
                  f"{t_mesh:.3f} s", flush=True)
            line = {"conf": conf_rel, "overlay": CONF_OVERLAY.strip(), "scene": gen_args,
                    "views": CONF_VIEWS, "img_res": [CONF_RES, CONF_RES], "generate_s": t_gen,
                    "steps": steps_run, "train_s": t_train, "resume_s": t_resume,
                    "eval_s": t_eval, "psnr": psnr, "loss": losses,
                    "ms_per_step": ms_step, "rays_per_s": exp.num_pixels / ms_step * 1e3,
                    "timed_steps": CONF_TIMED_STEPS, "warmup": WARMUP_STEPS,
                    "ms_per_step_rounds": rounds["trainer"],
                    "ms_per_step_prebuilt_rounds": rounds["prebuilt"],
                    "ms_host_batch": ms_batch, "profile": profiles, "mesh_verts": mesh_verts,
                    "sdf_min": sdf_min,
                    "ckpt_write_s": t_write, "ckpt_read_s": t_read, "ckpt_bytes": ck_bytes,
                    "plot_s": t_plot, "mesh_s": t_mesh, "mesh_resolution": exp.plot_resolution,
                    "routed": sorted(routed), "launches": counts}
            if tag in CONF_STEP_KERNELS:
                batch = trainer.sample_batch(exp.num_pixels)
                check, counts_k = step_check(what, cfg, batch, "bfloat16", dev, exp.loss)
                if not all(counts_k[k] for k in CONF_STEP_KERNELS[tag]):
                    fail(f"{what} step check: launches {_nonzero(counts_k)} miss a kernel of "
                         f"{CONF_STEP_KERNELS[tag]}")
                line["step_check_bfloat16"] = check
            lines[tag] = line
            trainer.close()
            del trainer, step
            torch.cuda.empty_cache()
    foreign = sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
    print(f"conf: modules of {list(FOREIGN)} imported: {foreign}", flush=True)
    if foreign:
        fail(f"the conf phase imported {foreign}")
    return lines


# the quality phase: the port's quality run (monosdf_torch/scripts/
# quality_run.py, the counterpart of scripts/quality_run.py) on the sphere
# and union confs at full width on the JAX evidence runs' scenes (12 views of
# 96x96, 1024 rays a step, meshes at 128), cut in length to the JAX CPU
# gates' form (tests/test_quality_gate.py); then the union model it trained
# against the plain versions, the mesh benchmark suites (cli/eval_mesh.py) and
# the trajectory renderer (cli/render.py) on its meshes
QUALITY_VIEWS, QUALITY_RES, QUALITY_MESH_RES = 12, 96, 128
QUALITY_GT_SAMPLES = 20_000  # the gates' Chamfer samples (the evidence runs' 200,000)
# run -> (conf, quality_run arguments, steps)
QUALITY_RUNS = {
    "sphere": ("confs/synth_sphere_quality.conf", [], 1000),
    "union": ("confs/synth_union_quality.conf", ["--shape", "union", "--tag", "union"], 900),
}
# the union scene's views rendered with the kernels, the plain versions and the
# float64 witness: two of its 12, held out of the choice of WITNESS_F
QUALITY_RENDER_VIEWS = (8, 9)
# cli/eval_mesh.py flavors on the union mesh (the scene's 12 views at 96x96);
# the DTU flavor in the scene's units (its defaults are DTU's millimetres)
SUITE_FLAVORS = {
    "scannet": ["--pose_stride", "1"],
    "replica": [],
    "dtu": ["--mask_cull", "--downsample", "0.01", "--max_dist", "1.0"],
    "generic": [],
}
# the flavors whose path runs on the device (scannet: the refuse's z-buffer
# and volume; dtu: the mask dilation), card against CPU, relative, the CPU
# tests' bars (tests/test_torch_mesh_eval.py): 1e-4 through the refuse, 1e-6
# where no rasterization is in the path. replica and generic are host numpy
# and scipy only, so they run once.
SUITE_RTOL = {"scannet": 1e-4, "dtu": 1e-6}
SUITE_GT_RES = 256  # the analytic union marched as the suites' ground truth
# the rasterized analytic sphere: each pixel both cover within RASTER_BAR_CELLS
# cells of the marched mesh (at RASTER_SPHERE_RES over MESH_BOUNDARY) of the
# ray-sphere depth. Its vertices lie on the sphere to O(h^2); a face lies
# inside by at most its sagitta s <= (sqrt(3) h)^2 / (8 r), and a ray grazing
# the silhouette meets it up to sqrt(2 r s) <= 0.87 h deeper.
RASTER_SPHERE_RES, RASTER_BAR_CELLS = 256, 2.0
TRAJ_FRAMES, TRAJ_RES = 24, (480, 640)
TRAJ_EDGE_PIXELS = 2  # the rasterizer's edge allowance (tests/test_torch_mesh_eval.py)


def _quality_run(dev, tmp: str, name: str) -> tuple:
    """One QUALITY_RUNS run through quality_run.main on the card, launches
    counted from 0; its JAX gate's bars checked. Returns the line and the
    run's paths."""
    from monosdf_torch.kernels import build
    from monosdf_torch.meshing import mesh_topology, read_ply
    from monosdf_torch.scripts import quality_run

    conf_rel, extra, steps = QUALITY_RUNS[name]
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, f"quality_{name}")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    results, curve = quality_run.main([
        "--root", root, "--iters", str(steps), "--res", str(QUALITY_RES),
        "--views", str(QUALITY_VIEWS), "--mesh_res", str(QUALITY_MESH_RES),
        "--gt_samples", str(QUALITY_GT_SAMPLES), "--conf", os.path.join(here, conf_rel),
        "--out_dir", os.path.join(tmp, "artifacts"), *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    exps = os.path.join(root, "exps")
    (run,) = os.listdir(exps)
    rows = quality_run.last_pass(
        [json.loads(line) for line in open(os.path.join(exps, run, "metrics.jsonl"))])
    tail = rows[-5:]
    loss = float(np.mean([r["loss"] for r in tail]))
    psnr = float(np.mean([r["psnr"] for r in tail]))
    ms = [1024 / r["rays_per_sec"] * 1e3 for r in rows[1:]]
    mesh = os.path.join(root, "eval", f"surface_{QUALITY_MESH_RES}.ply")
    verts, faces = read_ply(mesh)
    topo = mesh_topology(np.asarray(verts), np.asarray(faces))
    line = {"run": name, "conf": conf_rel, "views": QUALITY_VIEWS,
            "img_res": [QUALITY_RES, QUALITY_RES], "steps": rows[-1]["iter"], "seconds": seconds,
            "ms_per_step": float(np.mean(ms)), "ms_per_step_median": float(np.median(ms)),
            "first_loss": rows[0]["loss"], "tail_loss": loss, "tail_psnr": psnr,
            "verts": int(len(verts)), "faces": int(len(faces)),
            "components": topo["n_components"], "chamfer": results["chamfer_l1"],
            "f_score": results["f_score@5cm"], "normal_consistency": results["normal_consistency"],
            "eval_psnr": results["eval_psnr_mean"], "gt_samples": QUALITY_GT_SAMPLES,
            "mesh_resolution": QUALITY_MESH_RES, "launches": counts}
    checks = [(rows[0]["loss"] > 2 * loss, f"first loss {rows[0]['loss']:.4f} > 2 x tail {loss:.4f}")]
    if name == "sphere":
        # tests/test_quality_gate.py:56-100, against the JAX evidence curve
        ref_curve = json.load(open(os.path.join(here, "docs/quality/results.json")))["curve"]
        ref = max((r for r in ref_curve if r["iter"] <= steps), key=lambda r: r["iter"])
        radius_err = float(np.abs(np.linalg.norm(verts, axis=-1) - 0.5).mean())
        line.update(ref_iter=ref["iter"], loss_bar=1.6 * ref["loss"], psnr_bar=ref["psnr"] - 3.0,
                    mean_radius_error=radius_err, radius_bar=0.30, verts_bar=500)
        checks += [(loss <= 1.6 * ref["loss"], f"tail loss {loss:.4f} <= {1.6 * ref['loss']:.4f}"),
                   (psnr >= ref["psnr"] - 3.0, f"tail PSNR {psnr:.2f} >= {ref['psnr'] - 3.0:.2f}"),
                   (len(verts) > 500, f"{len(verts)} vertices > 500"),
                   (radius_err <= 0.30, f"mean |r - 0.5| {radius_err:.4f} <= 0.30")]
    else:
        # tests/test_quality_gate.py:262-290
        line.update(loss_bar=0.2, psnr_bar=14.0, components_bar=2, chamfer_bar=0.16)
        checks += [(loss <= 0.2, f"tail loss {loss:.4f} <= 0.2"),
                   (psnr >= 14.0, f"tail PSNR {psnr:.2f} >= 14"),
                   (topo["n_components"] >= 2, f"{topo['n_components']} components >= 2"),
                   (results["chamfer_l1"] <= 0.16, f"Chamfer {results['chamfer_l1']:.4f} <= 0.16")]
    print(f"quality {name}: {conf_rel} {line['steps']} steps in {seconds:.1f} s "
          f"({line['ms_per_step']:.3f} ms a step); Chamfer {results['chamfer_l1']:.5f}, F-score "
          f"{results['f_score@5cm']:.4f}, NC {results['normal_consistency']:.4f}, eval PSNR "
          f"{results['eval_psnr_mean']:.2f}; launches {_nonzero(counts)}; bars: "
          f"{[(ok, what) for ok, what in checks]}", flush=True)
    for ok, what in checks:
        if not ok:
            fail(f"quality {name}: the JAX gate's bar missed: {what}")
    if not all(counts[k] for k in ("sdf_mlp", "sampler_machinery", "sdf_grad", "sdf_grad_bwd",
                                   "radiance_norm", "radiance_norm_bwd")):
        fail(f"quality {name}: a kernel of the conf's path was not launched: {_nonzero(counts)}")
    return line, {"root": root, "run_dir": os.path.join(exps, run), "mesh": mesh,
                  "conf": os.path.join(here, conf_rel)}


def _ray_sphere_depth(K, pose, H: int, W: int, radius: float = 0.5) -> np.ndarray:
    """Camera z of the first hit of each pixel centre's ray on the sphere
    |x| = radius (0 where the ray misses), float64."""
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    d_cam = np.linalg.solve(np.asarray(K, np.float64)[:3, :3],
                            np.stack([u, v, np.ones_like(u)], 0).reshape(3, -1))  # z = 1
    R, o = np.asarray(pose, np.float64)[:3, :3], np.asarray(pose, np.float64)[:3, 3]
    d = (R @ d_cam).T
    a, b, c = (d * d).sum(-1), 2 * d @ o, o @ o - radius ** 2
    disc = b * b - 4 * a * c
    t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
    return np.where((disc > 0) & (t > 0), t, 0.0).reshape(H, W)


# The float64 witness gates of the trained union model (trained_union_checks).
# A render with every forward kernel of the render path replaced by its
# float64 witness (monosdf_torch/scripts/witness.py) stands for the truth;
# the kernel render is held to lie no farther from it than the plain render
# does, for each output and dtype:
#     stat |kernel - witness| <= F * stat |plain - witness| + a
# at the kernel render's own samples (K2f, K3f witnessed) for stat = max and
# mean over all entries, and through the sampler (K1, K4, K2f, K3f
# witnessed, from the same rays and linspace draws) for the max, the mean and
# the 99th percentile. F was set before the run that tests it, from PR 18's
# fixed-sample witness (both bf16 renders 1.795e-2 off it in rgb, the float32
# kernel render 7.87e-6 against the plain render's 2.48e-5) and from the same
# trained model's views 0-7 (``chip_smoke.py --witness 0,1 2,3 4,5 6,7``,
# PERF.md §6); the gate runs on views 8 and 9 (QUALITY_RENDER_VIEWS), which
# that choice never saw:
# - 1.5 for the statistics that many rays set: the mean at fixed samples
#   (calibration ratios kernel / plain <= 1.00) and the 99th percentile
#   through the sampler (<= 1.13): a third of slack over two float32 sum
#   orders equally far from float64;
# - 2 for the max at fixed samples: float32 depth's max is one ray whose
#   weight sits on a sample within beta of the surface (ratios <= 1.45);
# - 2.5 for the mean through the sampler and 4 for its max: there one float32
#   ulp that flips a bisection or a sample moves a ray by up to the scene's
#   depth (1.8), so a handful of rays set them, and which render draws the
#   worst rays varies from view to view (ratios 0.70-1.72 and 0.65-2.81,
#   either way).
# a = 1e-8 is the floor where both renders meet the witness.
WITNESS_F = {"fixed": {"max": 2.0, "mean": 1.5},
             "sampler": {"max": 4.0, "mean": 2.5, "p99": 1.5}}
WITNESS_A = 1e-8
WITNESS_QUANTILE = 0.99


def _witness_stats(kernel, plain, witness, with_quantile: bool) -> dict:
    """Over every entry of one output: the max, mean (and 99th percentile) of
    |kernel - witness| and |plain - witness|, and the entries where either
    side lies strictly nearer the witness."""
    ekw = (kernel - witness).abs().flatten()
    epw = (plain - witness).abs().flatten()
    out = {"kernel_vs_plain": float((kernel - plain).abs().max()),
           "max": [float(ekw.max()), float(epw.max())],
           "mean": [float(ekw.mean()), float(epw.mean())]}
    if with_quantile:
        out["p99"] = [float(torch.quantile(ekw, WITNESS_QUANTILE)),
                      float(torch.quantile(epw, WITNESS_QUANTILE))]
    out.update(entries_kernel_nearer=int((ekw < epw).sum()),
               entries_plain_nearer=int((epw < ekw).sum()), entries=int(ekw.numel()))
    return out


def witness_gates(tag: str, dname: str, where: str, stats: dict) -> dict:
    """Each statistic of each output against WITNESS_F and WITNESS_A: adds
    ``<stat>_bound`` and ``<stat>_met`` to each and returns the outputs that
    missed, printed with their numbers."""
    missed, a = {}, WITNESS_A
    for k, st in stats.items():
        for stat, F in WITNESS_F[where].items():
            kw, pw = st[stat]
            st[f"{stat}_bound"] = F * pw + a
            st[f"{stat}_met"] = kw <= F * pw + a
            if not st[f"{stat}_met"]:
                missed[f"{k} {stat}"] = f"{kw:.3e} > {F} x {pw:.3e} + {a:.1e}"
    print(f"{tag} {dname}: float64 witness gates ({where}): "
          f"{json.dumps({k: {s: st[f'{s}_met'] for s in WITNESS_F[where]} for k, st in stats.items()})}"
          f"{'; missed ' + json.dumps(missed) if missed else ''}", flush=True)
    return missed


class _witnesses_in_place:
    """The render path's forward kernels replaced by their float64
    witnesses at their call sites (K1 at the sweeps, K4 in the sampler, the
    K2 and K3 modules' forwards), ``which`` naming those to replace; the
    kernels back on exit."""

    def __init__(self, which=("sdf_mlp", "sampler_machinery", "sdf_grad", "radiance_norm"),
                 wrap=None):
        from monosdf_torch.scripts import witness as w

        f64 = {"sdf_mlp": w.k1_float64, "sampler_machinery": w.k4_float64,
               "sdf_grad": w.k2f_float64, "radiance_norm": w.k3f_float64}
        self.sites = [(mod, attr, (wrap or {}).get(name, f64[name]))
                      for name, mod, attr, _ in _render_kernel_sites() if name in which]

    def __enter__(self):
        for mod, attr, fn in self.sites:
            _KERNEL_FNS.setdefault((mod, attr), getattr(mod, attr))
            setattr(mod, attr, fn)

    def __exit__(self, *exc):
        for mod, attr, _ in self.sites:
            setattr(mod, attr, _KERNEL_FNS[(mod, attr)])


def float64_witness(tag: str, dname: str, model, cfg, chunks) -> dict:
    """Each chunk rendered three ways at the kernel render's own samples
    (render_samples): with the kernels, with their plain versions, and with
    K2f and K3f replaced by their float64 witnesses (the rest of the render
    is the same float32 code in all three); and three ways through the
    sampler (render_rays, the same rays and linspace draws): with the
    kernels, with the plain versions, and with K1, K4, K2f and K3f all
    replaced by their witnesses. Per output, over all chunks, the
    statistics of _witness_stats (the 99th percentile through the sampler);
    per output of K2f and K3f on each call's own inputs at the fixed
    samples, and of K1 on the kernel render's sweeps, the kernel's and the
    plain version's max abs off the witness (K1's also its mean and the
    entries off it).
    Prints the numbers; returns them (witness_gates gates them)."""
    from monosdf_torch.cli.eval import OUTPUT_KEYS
    from monosdf_torch.kernels import radiance_norm as k3
    from monosdf_torch.kernels import sdf_grad as k2
    from monosdf_torch.models import fields
    from monosdf_torch.models.monosdf import render_rays, render_samples
    from monosdf_torch.scripts.witness import k1_float64, k2f_float64, k3f_float64

    trunk = {}

    def recorded(mod, f64, plain, names):
        kernel = _KERNEL_FNS.setdefault((mod, "_forward"), mod._forward)

        def fn(*a, **kw):
            w, k, p = f64(*a, **kw), kernel(*a, **kw), plain(*a, **kw)
            for name, wi, ki, pi in zip(names, w, k, p):
                e = trunk.setdefault(name, {"kernel": 0.0, "plain": 0.0})
                e["kernel"] = max(e["kernel"], float((ki.double() - wi.double()).abs().max()))
                e["plain"] = max(e["plain"], float((pi.double() - wi.double()).abs().max()))
            return w
        return fn

    fixed_wrap = {"sdf_grad": recorded(k2, k2f_float64, k2.sdf_mlp_with_grad_plain,
                                       ("sdf", "feat", "grad")),
                  "radiance_norm": recorded(k3, k3f_float64, k3.radiance_norm_plain,
                                            ("rgb_pre", "normals"))}
    # K1 on the kernel render's own sweeps: its output and its plain version's
    # against the witness (max, mean, entries off it); the render goes on
    # with the kernel's output
    sweeps = {"kernel": [0.0, 0.0, 0], "plain": [0.0, 0.0, 0], "entries": 0}
    k1_kernel = _KERNEL_FNS.setdefault((fields, "sdf_mlp"), fields.sdf_mlp)
    k1_plain = dict((n, p) for n, _, _, p in _render_kernel_sites())["sdf_mlp"]

    def k1_recorded(*a, **kw):
        k = k1_kernel(*a, **kw)
        w = k1_float64(*a, **kw)
        for side, out in (("kernel", k), ("plain", k1_plain(*a, **kw))):
            e = (out.double() - w.double()).abs()
            r = sweeps[side]
            r[0], r[1], r[2] = max(r[0], float(e.max())), r[1] + float(e.sum()), r[2] + int((e > 0).sum())
        sweeps["entries"] += k.numel()
        return k

    renders = {"fixed": [], "sampler": []}
    with torch.no_grad():
        for rays, ic in chunks:
            with _witnesses_in_place(("sdf_mlp",), {"sdf_mlp": k1_recorded}):
                out_k = render_rays(model, cfg, rays, image_code=ic)
            use_plain_versions(True)
            out_p = render_samples(model, cfg, rays, out_k["z_vals"], ic)
            out_ps = render_rays(model, cfg, rays, image_code=ic)
            use_plain_versions(False)
            with _witnesses_in_place(("sdf_grad", "radiance_norm"), fixed_wrap):
                out_w = render_samples(model, cfg, rays, out_k["z_vals"], ic)
            with _witnesses_in_place():
                out_ws = render_rays(model, cfg, rays, image_code=ic)
            for where, p, w in (("fixed", out_p, out_w), ("sampler", out_ps, out_ws)):
                renders[where].append({k: (out_k[k].double(), p[k].double(), w[k].double())
                                       for k in OUTPUT_KEYS})

    n = max(sweeps["entries"], 1)
    trunk["sdf_sweeps"] = {side: sweeps[side][0] for side in ("kernel", "plain")}
    out = {"rays": sum(int(c["rays_o"].shape[0]) for c, _ in chunks),
           "trunk_max_abs_off_witness": trunk,
           "sweeps_off_witness": {side: {"max": sweeps[side][0], "mean": sweeps[side][1] / n,
                                         "entries_off": sweeps[side][2]}
                                  for side in ("kernel", "plain")} | {"entries": sweeps["entries"]}}
    for where, rs in renders.items():
        out[where] = {k: _witness_stats(*(torch.cat([r[k][i] for r in rs]) for i in range(3)),
                                        with_quantile=where == "sampler")
                      for k in OUTPUT_KEYS}
    for k in OUTPUT_KEYS:
        kp, bar = out["fixed"][k]["kernel_vs_plain"], RENDER_FIXED_MAX_ABS[dname][k]
        out["fixed"][k].update(phase8_bar=bar, phase8_bar_met=kp <= bar)

    def short(d):
        return {n: ([float(f"{x:.3e}") for x in v] if isinstance(v, list) else
                    float(f"{v:.3e}") if isinstance(v, float) else v) for n, v in d.items()}

    for where, what in (("fixed", "at the kernel render's samples"),
                        ("sampler", "through the sampler")):
        print(f"{tag} {dname}: float64 witness {what}, {out['rays']} rays, [kernel, plain] "
              f"vs witness: {json.dumps({k: short(out[where][k]) for k in OUTPUT_KEYS})}",
              flush=True)
    print(f"{tag} {dname}: K1 (the kernel render's sweeps), K2f and K3f on their own inputs, "
          f"max abs off the witness: {json.dumps({n: short(e) for n, e in trunk.items()})}; "
          f"K1's sweeps: {json.dumps({k: short(v) if isinstance(v, dict) else v for k, v in out['sweeps_off_witness'].items()})}",
          flush=True)
    return out


def _trained_union(dev, run: dict, views):
    """The union model a quality run trained, per dtype (bf16, float32):
    (dname, model, cfg, the 1024-ray chunks of ``views`` of its scene, its
    beta), the model loaded from the run's latest checkpoint."""
    from monosdf_torch.cli.common import dataset_config_from_conf
    from monosdf_torch.cli.eval import dataset_frames
    from monosdf_torch.config import build_configs, load_conf
    from monosdf_torch.data.scene_dataset import SceneDataset
    from monosdf_torch.models.monosdf import init_monosdf
    from monosdf_torch.ops.density import get_beta
    from monosdf_torch.params import load_jax_params
    from monosdf_torch.train.checkpoint import load_checkpoint

    exp = build_configs(load_conf(run["conf"]))
    ds = SceneDataset(dataset_config_from_conf(exp.dataset, os.path.join(run["root"], "data"),
                                               "", "train"))
    params = load_checkpoint(os.path.join(run["run_dir"], "checkpoints"))["params"]
    all_frames = dataset_frames(ds, dev)
    frames = [all_frames[i] for i in views]
    for dname in ("bfloat16", "float32"):
        cfg = dataclasses.replace(exp.model, compute_dtype=dname,
                                  mixed_precision=dname == "bfloat16")
        model = load_jax_params(init_monosdf(cfg, device=dev), params)
        beta = float(get_beta(model.density.beta.detach(), cfg.beta_min))
        yield dname, model, cfg, chunks_of(frames, model, cfg), beta


def trained_union_checks(dev, run: dict) -> dict:
    """The union model a quality run trained against the plain versions, in
    bf16 and float32, on QUALITY_RENDER_VIEWS of its scene. Gated: each
    forward kernel on the inputs its render at the trained beta gives it
    (phase 3's bars, recorded_kernel_checks); at the trained model's own beta
    (~1e-3) the kernel render against the float64 witness (float64_witness),
    at the kernel render's samples and through the sampler, at
    witness_gates' bounds; and the trained weights rendered at the kernel
    render's own samples at phase 8's bars with the density at phase 8's beta
    (the conf's initial 0.1). The recorded inputs come from the first view's
    middle chunk, whose rays meet the surface. Returns the errors and the
    witness's numbers; fails past a bar or a bound."""
    out = {"views": list(QUALITY_RENDER_VIEWS)}
    tag = "quality union (trained)"
    missed = {}
    for dname, model, cfg, chunks, beta in _trained_union(dev, run, QUALITY_RENDER_VIEWS):
        per_view = len(chunks) // len(QUALITY_RENDER_VIEWS)
        at = f"{tag}, its beta {beta:.3e}"
        rec = recorded_kernel_checks(at, dname, model, cfg, chunks[per_view // 2])
        wit = float64_witness(at, dname, model, cfg, chunks)
        for where in ("fixed", "sampler"):
            for k, v in witness_gates(at, dname, where, wit[where]).items():
                missed[f"{dname} {where} {k}"] = v
        with torch.no_grad():
            model.density.beta.fill_(cfg.beta_init)
        _, errs = like_for_like(f"quality union (trained weights, phase 8's beta {cfg.beta_init})",
                                dname, model, cfg, chunks, None)
        out[dname] = {"recorded_at_trained_beta": rec, "trained_beta": beta,
                      "witness_at_trained_beta": wit, "phase8_beta": cfg.beta_init,
                      "fixed_samples_at_phase8_beta": errs["fixed samples"]}
        del model
    if missed:
        fail(f"{tag}: the kernel render lies farther from the float64 witness than the "
             f"bound allows: {missed}")
    return out


def witness_study(dev, groups) -> dict:
    """``chip_smoke.py --witness 0,1 2,3 ...``: the union quality run of
    QUALITY_RUNS trained as the quality phase trains it, then for each group
    of its scene's views and each dtype the float64 witness's statistics
    (float64_witness) and witness_gates' verdicts, printed and returned; no
    gate fails the run. The views WITNESS_F was chosen on."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        _, run = _quality_run(dev, tmp, "union")
        for views in groups:
            for dname, model, cfg, chunks, beta in _trained_union(dev, run, views):
                at = f"witness study, views {list(views)}, beta {beta:.3e}"
                wit = float64_witness(at, dname, model, cfg, chunks)
                missed = {where: witness_gates(at, dname, where, wit[where])
                          for where in ("fixed", "sampler")}
                out[f"{views} {dname}"] = {"witness": wit, "missed": missed}
                del model
    return out


def quality_phase(dev):
    """Phase 12: the quality run and the evaluation stack on the card. Two
    runs of QUALITY_RUNS through monosdf_torch.scripts.quality_run.main (the
    port's generator writes each scene, cli/train.py --conf trains it,
    cli/eval.py --conf meshes it at 128 and renders its val frame, the
    metrics against the analytic surface), each held to its JAX gate's bars
    (the sphere's relative to the JAX evidence curve), launches counted over
    each run; the union model it trained against the plain versions
    (trained_union_checks); cli/eval_mesh.py on the union
    mesh in each flavor against the analytic union marched at SUITE_GT_RES,
    the flavors with device code (SUITE_RTOL) also with --device cpu,
    agreeing within SUITE_RTOL; the
    analytic sphere mesh rasterized from the sphere scene's 12 cameras
    against the ray-sphere depth (RASTER_BAR_CELLS); cli/render.py on the
    sphere mesh, TRAJ_FRAMES frames at TRAJ_RES in each shading, and one
    depth frame on the card against the CPU. Fails where a module of
    FOREIGN was imported. Returns the quality, mesh_eval and render_traj
    lines."""
    import tempfile

    from monosdf_torch.cli import eval_mesh, render as render_cli
    from monosdf_torch.eval.metrics import sample_mesh_surface
    from monosdf_torch.mesh_eval import TSDFVolume, rasterize_depth
    from monosdf_torch.meshing import extract_mesh, read_ply, write_ply
    from monosdf_torch.render import poses_from_cameras, render_mesh_frame
    from monosdf_torch.scripts.make_synthetic_scene import union_sdf_torch

    t_phase = time.perf_counter()
    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in QUALITY_RUNS:
            lines[f"quality_{name}"], paths[name] = _quality_run(dev, tmp, name)

        lines["quality_union"]["trained_vs_plain"] = trained_union_checks(dev, paths["union"])
        torch.cuda.empty_cache()

        # the mesh benchmark suites on the union mesh, card and CPU
        u = paths["union"]
        def analytic(pts):
            return union_sdf_torch(pts)

        vg, fg = extract_mesh(analytic, resolution=SUITE_GT_RES, grid_boundary=MESH_BOUNDARY,
                              device=dev)
        gt_mesh, gt_pts = os.path.join(tmp, "union_gt.ply"), os.path.join(tmp, "union_gt.npy")
        write_ply(gt_mesh, vg, fg)
        np.save(gt_pts, sample_mesh_surface(vg, fg, 200_000)[0])
        suites = {}
        for flavor, extra in SUITE_FLAVORS.items():
            argv = ["--flavor", flavor, "--mesh", u["mesh"], "--data_root",
                    os.path.join(u["root"], "data"), "--data_dir", "union_scene",
                    "--img_res", str(QUALITY_RES), str(QUALITY_RES), *extra,
                    *(["--gt_points", gt_pts] if flavor == "dtu" else ["--gt_mesh", gt_mesh])]
            got = {}
            for where in (str(dev), "cpu") if flavor in SUITE_RTOL else (str(dev),):
                t0 = time.perf_counter()
                got[where] = (eval_mesh.main(argv + ["--device", where]),
                              time.perf_counter() - t0)
            m_card, s_card = got[str(dev)]
            suites[flavor] = {"seconds": s_card, "metrics": m_card}
            if flavor not in SUITE_RTOL:
                print(f"mesh_eval {flavor}: {s_card:.2f} s (host only); {json.dumps(m_card)}",
                      flush=True)
                if not m_card or not all(np.isfinite(v) for v in m_card.values()):
                    fail(f"mesh_eval {flavor}: metrics {m_card}")
                continue
            m_cpu, s_cpu = got["cpu"]
            off = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu}
            suites[flavor].update(cpu_seconds=s_cpu, max_rel_card_cpu=max(off.values()),
                                  rtol=SUITE_RTOL[flavor])
            if flavor == "scannet":  # the refuse's volume (refuse_mesh's bbox, 1 cm voxels)
                uv = read_ply(u["mesh"])[0]
                vol = TSDFVolume(uv.min(0) - 0.05, uv.max(0) + 0.05, 0.01, device=dev)
                suites[flavor].update(views_fused=QUALITY_VIEWS,
                                      voxels_fused=int(np.prod(vol.dims)))
                del vol
            print(f"mesh_eval {flavor}: {s_card:.2f} s on the card, {s_cpu:.2f} s on the CPU; "
                  f"{json.dumps(m_card)}; card vs CPU max rel {max(off.values()):.3e} "
                  f"(bar {SUITE_RTOL[flavor]})", flush=True)
            if set(m_card) != set(m_cpu) or max(off.values()) > SUITE_RTOL[flavor]:
                fail(f"mesh_eval {flavor}: the card's metrics {m_card} and the CPU's {m_cpu}")

        # the analytic sphere from the sphere scene's 12 cameras
        s = paths["sphere"]
        Ks, poses = poses_from_cameras(os.path.join(s["root"], "data", "sphere_scene",
                                                    "cameras.npz"))
        vs, fs = extract_mesh(lambda p: torch.linalg.norm(p, dim=-1) - 0.5,
                              resolution=RASTER_SPHERE_RES, grid_boundary=MESH_BOUNDARY, device=dev)
        cell = (MESH_BOUNDARY[1] - MESH_BOUNDARY[0]) / RASTER_SPHERE_RES
        worst, covered, t_raster = 0.0, 0, 0.0
        for K, pose in zip(Ks, poses):
            t0 = time.perf_counter()
            depth = rasterize_depth(vs, fs, K, pose, QUALITY_RES, QUALITY_RES, device=dev)
            t_raster += time.perf_counter() - t0
            ref = _ray_sphere_depth(K, pose, QUALITY_RES, QUALITY_RES)
            both = (depth > 0) & (ref > 0)
            covered += int(both.sum())
            worst = max(worst, float(np.abs(depth[both] - ref[both]).max()) / cell)
        raster = {"views": len(Ks), "img_res": [QUALITY_RES, QUALITY_RES],
                  "mesh_resolution": RASTER_SPHERE_RES, "faces": int(len(fs)),
                  "pixels_both": covered, "max_err_cells": worst, "bar_cells": RASTER_BAR_CELLS,
                  "ms_per_view": t_raster / len(Ks) * 1e3}
        print(f"mesh_eval raster: the analytic sphere at {RASTER_SPHERE_RES} ({len(fs)} faces) "
              f"from {len(Ks)} cameras: {covered} pixels both cover, worst |depth - ray-sphere| "
              f"{worst:.3f} cells (bar {RASTER_BAR_CELLS}), {raster['ms_per_view']:.2f} ms a view",
              flush=True)
        if worst > RASTER_BAR_CELLS or covered < len(Ks) * 100:
            fail(f"mesh_eval raster: {worst:.3f} cells off the ray-sphere depth, {covered} pixels")
        lines["mesh_eval"] = {"mesh": "union quality mesh", "gt_resolution": SUITE_GT_RES,
                              "flavors": suites, "raster_sphere": raster}

        # the trajectory renderer on the sphere mesh
        cams = os.path.join(s["root"], "data", "sphere_scene", "cameras.npz")
        traj = {}
        for shading in ("depth", "normal", "lambert"):
            out = os.path.join(tmp, f"traj_{shading}")
            t0 = time.perf_counter()
            frames_out = render_cli.main(["--mesh", s["mesh"], "--cameras", cams, "--out", out,
                                          "--n_frames", str(TRAJ_FRAMES), "--img_res",
                                          *map(str, TRAJ_RES), "--shading", shading])
            ms = (time.perf_counter() - t0) / TRAJ_FRAMES * 1e3
            written = [p for p in frames_out if os.path.getsize(p) > 0]
            traj[shading] = {"frames": len(written), "ms_per_frame": ms}
            print(f"render_traj {shading}: {len(written)} frames at {TRAJ_RES} in "
                  f"{ms:.2f} ms a frame", flush=True)
            if len(written) != TRAJ_FRAMES:
                fail(f"render_traj {shading}: {len(written)} frames written of {TRAJ_FRAMES}")
        sv, sf = read_ply(s["mesh"])
        K0, pose0 = Ks[0], poses[0]
        a = render_mesh_frame(sv, sf, K0, pose0, *TRAJ_RES, "depth", device=dev)
        b = render_mesh_frame(sv, sf, K0, pose0, *TRAJ_RES, "depth", device="cpu")
        diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
        traj["card_vs_cpu"] = {"pixels_off": int((diff > 0).sum()),
                               "pixels_off_past_one_level": int((diff > 1).sum()),
                               "edge_pixels_bar": TRAJ_EDGE_PIXELS,
                               "hit_pixels": int((a != 255).any(-1).sum())}
        print(f"render_traj card vs cpu (depth frame): {traj['card_vs_cpu']}", flush=True)
        if int((diff > 1).sum()) > TRAJ_EDGE_PIXELS or not traj["card_vs_cpu"]["hit_pixels"]:
            fail(f"render_traj: the card's depth frame against the CPU's: {traj['card_vs_cpu']}")
        lines["render_traj"] = traj
    foreign = sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
    print(f"quality: modules of {list(FOREIGN)} imported: {foreign}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if foreign:
        fail(f"the quality phase imported {foreign}")
    lines["mesh_eval"]["seconds"] = time.perf_counter() - t_phase
    return lines


# ---------------------------------------------------------------------------
# Phase 13: the data pipeline, from a raw ScanNet-layout scene to a mesh
PRE_RAW_HW, PRE_DEPTH_HW = (968, 1296), (480, 640)  # ScanNet's colour and depth frames
# ScanNet's typical colour intrinsics (fx, fy, cx, cy); the depth camera's are
# the same optics scaled to its frame
PRE_K = (1170.19, 1170.19, 647.75, 483.75)
PRE_STRIDE, PRE_RAW_FRAMES = 2, 11  # every second raw frame: 6 views
PRE_IMAGE_SIZE = 384  # cli/preprocess.py scannet's default, the conf's img_res
PRE_CONF = "confs/scannet_mlp.conf"
# scannet_mlp.conf has no tpu block, so its backends default to 'jnp' and it
# routes no kernel (as in the JAX package); the phase layers on it, with
# --conf_add, the tpu block that confs/synth_union_quality.conf carries: bf16,
# the sweeps, the machinery and K2 on the kernels, the radiance through K3
PRE_OVERLAY = ("tpu{ compute_dtype = bfloat16, mixed_precision = True, sampler_backend = pallas,"
               " diff_backend = pallas, rgb_backend = fused, sampler_machinery = pallas }\n")
# a few steps: in its first ones the model's interior (the room, inside_outside)
# shrinks (on the CPU at 256 rays a step its largest SDF on a 33^3 grid went
# 0.59, 0.51, 0.35, 0.24 at steps 0, 5, 10, 20), and on the card after 20
# steps no positive value was left to mesh
PRE_STEPS = 5
PRE_MESH_RES = 256
PRE_ROOM_HALF = 1.5  # metres: the generator's room scaled to a ScanNet room
# the stand-in cue network's maps, card against CPU (max abs; the maps lie in
# [0, 1]): float32 convolutions summed in another order, ~1e-6
PRE_CUE_BAR = 1e-4


class _CueStandIn(torch.nn.Module):
    """A seeded convolutional stand-in for the Omnidata cue networks (whose
    weights are an external download): (1, 3, H, W) -> (1, C, H, W) in
    [0, 1]. Its outputs are not cues; they exercise the cue path."""

    def __init__(self, out_ch: int):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 16, 3, padding=1)
        self.c2 = torch.nn.Conv2d(16, out_ch, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(self.c2(torch.relu(self.c1(x))))


def _raw_scannet_scene(root: str) -> str:
    """PRE_RAW_FRAMES frames of the generator's textured room
    (make_synthetic_scene.room_albedo, its lighting and camera path, the room
    PRE_ROOM_HALF wide a side) in ScanNet's raw layout and sizes:
    frames/color/<i>.png (968 x 1296 RGB), frames/depth/<i>.png (480 x 640,
    16-bit millimetres), frames/pose/<i>.txt (camera to world, OpenCV axes)
    and intrinsic/intrinsic_color.txt. Written through data/png.py."""
    from monosdf_torch.data.png import write_png
    from monosdf_torch.data.synthetic import _look_at
    from monosdf_torch.scripts.make_synthetic_scene import room_albedo

    for sub in ("frames/color", "frames/depth", "frames/pose", "intrinsic"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    fx, fy, cx, cy = PRE_K
    K4 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"), K4)
    half, s = PRE_ROOM_HALF, PRE_ROOM_HALF / 0.55
    light = np.array([0.35, 0.75, -0.55])
    light /= np.linalg.norm(light)
    heights = (-0.14, 0.0, 0.16)

    def cast(pose, H, W, sx):
        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        d_cam = np.stack([(u - cx * sx) / (fx * sx), (v - cy * sx) / (fy * sx),
                          np.ones_like(u)], -1)
        d = d_cam @ pose[:3, :3].T.astype(np.float64)
        o = pose[:3, 3].astype(np.float64)
        with np.errstate(divide="ignore"):
            t_axis = np.where(d > 0, (half - o) / d, np.where(d < 0, (-half - o) / d, np.inf))
        face = np.argmin(t_axis, axis=-1)
        t = np.min(t_axis, axis=-1)  # along d, whose camera z is 1: t is the z-depth
        return o + t[..., None] * d, face, np.take_along_axis(d, face[..., None], -1)[..., 0], t

    for i in range(PRE_RAW_FRAMES):
        ang = 2 * np.pi * i / PRE_RAW_FRAMES
        eye = s * np.array([0.3 * np.sin(ang), heights[i % 3], -0.3 * np.cos(ang)])
        target = s * np.array([-0.2 * np.sin(ang), 0.3 * np.sin(1.7 * i + 0.4),
                               0.2 * np.cos(ang)])
        pose = _look_at(eye, target)
        pts, face, d_hit, _ = cast(pose, *PRE_RAW_HW, 1.0)
        sign = np.where(d_hit > 0, 1, -1)
        normal = -np.eye(3)[face] * sign[..., None]
        shade = 0.4 + 0.6 * np.clip(normal @ -light, 0.0, 1.0)
        rgb = np.clip(room_albedo(pts, face, sign, half) * shade[..., None], 0, 1)
        write_png(os.path.join(root, "frames/color", f"{i}.png"), (rgb * 255).astype(np.uint8))
        _, _, _, z = cast(pose, *PRE_DEPTH_HW, PRE_DEPTH_HW[1] / PRE_RAW_HW[1])
        write_png(os.path.join(root, "frames/depth", f"{i}.png"),
                  np.round(z * 1000.0).astype(np.uint16))
        np.savetxt(os.path.join(root, "frames/pose", f"{i}.txt"), pose.astype(np.float64))
    return root


def _same_tree(a: str, b: str) -> dict:
    """Two converted scenes: every PNG's pixels, .npy array and cameras.npz
    entry of ``a`` against ``b``'s (max abs per kind; files only in one)."""
    from monosdf_torch.data.png import read_png

    files = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                             for d, _, fs in os.walk(r) for f in fs)
    fa, fb = files(a), files(b)
    out = {"files": len(fa), "only_one_side": sorted(set(fa) ^ set(fb)),
           "png_max_levels": 0, "npy_max_abs": 0.0, "cameras_max_abs": 0.0}
    for rel in sorted(set(fa) & set(fb)):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            x, y = read_png(pa).astype(np.int64), read_png(pb).astype(np.int64)
            out["png_max_levels"] = max(out["png_max_levels"], int(np.abs(x - y).max())
                                        if x.shape == y.shape else 10**9)
        elif rel.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            out["npy_max_abs"] = max(out["npy_max_abs"], float(np.abs(x - y).max())
                                     if x.shape == y.shape else math.inf)
        elif rel.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            if sorted(za.files) != sorted(zb.files):
                out["cameras_max_abs"] = math.inf
            for k in set(za.files) & set(zb.files):
                out["cameras_max_abs"] = max(out["cameras_max_abs"],
                                             float(np.abs(za[k] - zb[k]).max()))
    return out


def preprocess_phase(dev):
    """Phase 13: one user pipeline from a raw ScanNet-layout scene to meshes,
    through the port's entry points, on the card: _raw_scannet_scene at
    ScanNet's sizes; ``cli/preprocess.py scannet --image_size 384 --stride
    2`` (JPEG/PNG read on the host, the crop's resizes on the card); ``cues
    --task depth`` and ``--task normal`` with ``--model_path`` a TorchScript
    _CueStandIn; ``cli/train.py --conf confs/scannet_mlp.conf --conf_add
    <PRE_OVERLAY> --max_iters 5`` on the converted scene at full width
    (launches exactly the conf's routed kernels); the conf and its overlay
    written to the run's runconf.conf (the Trainer writes none), then ``scripts/extract_all_meshes.py --resolution 256``,
    which runs ``python -m monosdf_torch.cli.eval --conf ...`` for the run
    (executed in this process, so that its launches are counted: the command
    the script builds, its argument list handed to cli/eval.py's main);
    ``tools/cleanup.py --dry_run`` and ``tools/transfer.py --dry_run`` on the
    exps root. Held against the CPU: the conversion again with ``--device
    cpu`` (PNG pixels, .npy arrays and cameras.npz equal: the uint8 resizes
    are exact and the nearest resize copies values), the stand-in's cues with
    ``--device cpu`` on the card's converted frames (PRE_CUE_BAR), and the
    mesh against cli/eval.py's with each kernel's plain version in its
    wrapper's place (PR 16's bars, MESH_FACES_RTOL and MESH_VERT_CELLS),
    which must hold faces where the trained SDF takes both signs on a
    CONF_SDF_GRID^3 grid over the mesh box.
    Seconds per stage and per raw frame; launches counted over the phase.
    Fails where a module of FOREIGN was imported. Returns the
    ``preprocess`` line."""
    import contextlib
    import io
    import tempfile

    from monosdf_torch.cli import eval as ceval
    from monosdf_torch.cli import preprocess as cpre
    from monosdf_torch.cli import train as ctrain
    from monosdf_torch.config import build_configs, load_conf, routed_kernels
    from monosdf_torch.kernels import build
    from monosdf_torch.meshing import mesh_sdf_fn, read_ply
    from monosdf_torch.scripts import extract_all_meshes
    from monosdf_torch.tools import cleanup, transfer

    here = os.path.dirname(os.path.abspath(__file__))
    conf = os.path.join(here, PRE_CONF)
    t_phase = time.perf_counter()
    sec, checks = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        raw, data, data_cpu = (os.path.join(tmp, d) for d in ("raw", "data", "data_cpu"))
        scan, scan_cpu = os.path.join(data, "scannet", "scan1"), os.path.join(data_cpu, "scan1")
        t0 = time.perf_counter()
        _raw_scannet_scene(raw)
        sec["raw_scene"] = time.perf_counter() - t0

        torch.cuda.synchronize()
        build.reset_launch_counts()
        convert = ["scannet", "--scene_dir", raw, "--image_size", str(PRE_IMAGE_SIZE),
                   "--stride", str(PRE_STRIDE)]
        t0 = time.perf_counter()
        views = cpre.main(convert + ["--out", scan, "--device", str(dev)])
        sec["convert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpre.main(convert + ["--out", scan_cpu, "--device", "cpu"])
        sec["convert_cpu"] = time.perf_counter() - t0
        conv = _same_tree(scan, scan_cpu)
        checks.append((views == -(-PRE_RAW_FRAMES // PRE_STRIDE), f"{views} views converted"))
        checks.append((not conv["only_one_side"] and conv["png_max_levels"] == 0
                       and conv["npy_max_abs"] == 0.0 and conv["cameras_max_abs"] == 0.0,
                       f"the card's conversion equals the CPU's: {conv}"))

        nets = {}
        for task, ch in (("depth", 1), ("normal", 3)):
            torch.manual_seed(SEED + ch)
            nets[task] = os.path.join(tmp, f"{task}_standin.ts")
            torch.jit.script(_CueStandIn(ch).eval()).save(nets[task])
        cue_err, cue_cpu_dir = {}, os.path.join(tmp, "cues_cpu")
        sec["cues"] = sec["cues_cpu"] = 0.0
        for task in nets:
            args = ["cues", "--images", scan, "--task", task, "--model_path", nets[task]]
            t0 = time.perf_counter()
            cpre.main(args + ["--out", scan, "--device", str(dev)])
            torch.cuda.synchronize()
            sec["cues"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            cpre.main(args + ["--out", cue_cpu_dir, "--device", "cpu"])
            sec["cues_cpu"] += time.perf_counter() - t0
            names = sorted(f for f in os.listdir(scan) if f.endswith(f"_{task}.npy"))
            cue_err[task] = max(float(np.abs(np.load(os.path.join(scan, n))
                                             - np.load(os.path.join(cue_cpu_dir, n))).max())
                                for n in names)
            checks.append((len(names) == views and cue_err[task] <= PRE_CUE_BAR,
                           f"{len(names)} {task} maps, card vs CPU {cue_err[task]:.2e} <= "
                           f"{PRE_CUE_BAR}"))
        after_cues = launch_counts()
        checks.append((not any(after_cues.values()),
                       f"no kernel of the port's in conversion and cues: {_nonzero(after_cues)}"))

        exps, overlay = os.path.join(tmp, "exps"), os.path.join(tmp, "kernels.conf")
        with open(overlay, "w") as f:
            f.write(PRE_OVERLAY)
        t0 = time.perf_counter()
        trainer = ctrain.main(["--conf", conf, "--conf_add", overlay, "--data_root", data,
                               "--exps_root", exps, "--max_iters", str(PRE_STEPS),
                               "--timestamp", "smoke", "--device", str(dev)])
        torch.cuda.synchronize()
        sec["train"] = time.perf_counter() - t0
        train_counts = launch_counts()
        exp = build_configs(load_conf(conf, overlay))
        routed = set(routed_kernels(exp.model))
        rows = [json.loads(l) for l in open(os.path.join(trainer.run_dir, "metrics.jsonl"))]
        checks += [(set(_nonzero(train_counts)) == routed,
                    f"training launched {sorted(_nonzero(train_counts))}, routed {sorted(routed)}"),
                   (trainer.step == PRE_STEPS and rows
                    and all(math.isfinite(r["loss"]) for r in rows),
                    f"{trainer.step} steps, losses {[round(r['loss'], 4) for r in rows]}")]

        # the run's conf as the user wrote it: the conf and its overlay
        with open(os.path.join(trainer.run_dir, "runconf.conf"), "w") as f:
            f.write(open(conf).read() + "\n" + PRE_OVERLAY)
        meshes = os.path.join(tmp, "meshes")
        build.reset_launch_counts()
        ran = []

        class _Done:
            returncode = 0

        def in_process(cmd, **kw):  # the script's cli/eval.py command, run here
            if cmd[1:3] != ["-m", "monosdf_torch.cli.eval"]:
                fail(f"extract_all_meshes built {cmd}")
            ran.append(cmd[3:])
            ceval.main(cmd[3:])
            return _Done()

        saved_run = extract_all_meshes.subprocess.run
        extract_all_meshes.subprocess.run = in_process
        t0 = time.perf_counter()
        try:
            done = extract_all_meshes.main(["--exps_root", exps, "--data_root", data,
                                            "--out_dir", meshes, "--resolution",
                                            str(PRE_MESH_RES), "--device", str(dev)])
        finally:
            extract_all_meshes.subprocess.run = saved_run
        torch.cuda.synchronize()
        sec["extract_all_meshes"] = time.perf_counter() - t0
        mesh_counts = launch_counts()
        mesh_path = os.path.join(meshes, os.path.basename(trainer.run_dir),
                                 f"surface_{PRE_MESH_RES}.ply")
        vk, fk = read_ply(mesh_path)
        plain_dir = os.path.join(tmp, "mesh_plain")
        use_plain_versions(True)
        try:
            t0 = time.perf_counter()
            cmd = list(ran[0])
            cmd[cmd.index("--out_dir") + 1] = plain_dir
            ceval.main(cmd)
            sec["mesh_plain"] = time.perf_counter() - t0
        finally:
            use_plain_versions(False)
        if any(build.launches[k] != mesh_counts[k] for k in build.launches):
            fail(f"the plain-version mesh launched kernels: {_nonzero(launch_counts())}")
        vp, fp = read_ply(os.path.join(plain_dir, f"surface_{PRE_MESH_RES}.ply"))
        fk, fp = (np.zeros((0, 3), np.int64) if f is None else f for f in (fk, fp))
        cell = (exp.grid_boundary[1] - exp.grid_boundary[0]) / PRE_MESH_RES
        faces_rel = abs(len(fk) - len(fp)) / max(len(fp), 1)
        dist_cells = (_vertex_dist(vk, vp) / cell if len(vk) and len(vp)
                      else 0.0 if len(vk) == len(vp) else math.inf)
        # a mesh is due where the trained SDF takes both signs on the mesh box
        axis = torch.linspace(*exp.grid_boundary, CONF_SDF_GRID, device=dev)
        with torch.no_grad():
            sdf = mesh_sdf_fn(trainer.model, exp.model)(
                torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3))
        sdf_range = [float(sdf.min()), float(sdf.max())]
        checks += [(done == 1 and len(ran) == 1, f"{done} meshes from {len(ran)} runs"),
                   (set(_nonzero(mesh_counts)) == {"sdf_mlp"},
                    f"the mesh launched {_nonzero(mesh_counts)}"),
                   ((len(fk) > 0 or not sdf_range[0] < 0 < sdf_range[1])
                    and faces_rel <= MESH_FACES_RTOL and dist_cells <= MESH_VERT_CELLS,
                    f"mesh {len(vk)} verts {len(fk)} faces (the SDF on a {CONF_SDF_GRID}^3 grid "
                    f"in {sdf_range}) against the plain versions' {len(vp)} / {len(fp)}: faces "
                    f"{faces_rel:.2e} (bar {MESH_FACES_RTOL}), vertices {dist_cells:.2e} cells "
                    f"(bar {MESH_VERT_CELLS})")]

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            report = cleanup.main(["--exps_root", exps, "--dry_run"])
            cmds = transfer.main(["--run", trainer.run_dir, "--dest", "host:/exps", "--dry_run"])
        sec["tools"] = time.perf_counter() - t0
        kept = sorted(os.listdir(trainer.ckpt_dir))
        checks.append((len(cmds) >= 3 and all(c[:3] == ["rsync", "-a", "--mkpath"] for c in cmds)
                       and "latest.ckpt" in kept,
                       f"cleanup --dry_run {report}, transfer --dry_run {len(cmds)} rsync "
                       f"commands, checkpoints kept {kept}"))
        counts = {k: train_counts[k] + mesh_counts[k] for k in train_counts}
    sec["phase"] = time.perf_counter() - t_phase
    foreign = sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
    line = {"raw_frames": PRE_RAW_FRAMES, "raw_color_hw": list(PRE_RAW_HW),
            "raw_depth_hw": list(PRE_DEPTH_HW), "stride": PRE_STRIDE, "views": views,
            "image_size": PRE_IMAGE_SIZE, "conf": PRE_CONF, "overlay": PRE_OVERLAY.strip(),
            "steps": PRE_STEPS,
            "mesh_resolution": PRE_MESH_RES, "seconds": sec,
            "seconds_per_raw_frame": {k: sec[k] / PRE_RAW_FRAMES
                                      for k in ("raw_scene", "convert", "convert_cpu")},
            "conversion_card_vs_cpu": conv, "cues_card_vs_cpu_max_abs": cue_err,
            "cue_bar": PRE_CUE_BAR, "routed": sorted(routed),
            "launches_train": _nonzero(train_counts), "launches_mesh": _nonzero(mesh_counts),
            "mesh": {"verts": int(len(vk)), "faces": int(len(fk)), "plain_verts": int(len(vp)),
                     "plain_faces": int(len(fp)), "faces_rel_diff": faces_rel,
                     "vertex_dist_cells": dist_cells, "sdf_range": sdf_range},
            "launches": counts, "foreign_modules": foreign,
            "checks": [[ok, what] for ok, what in checks]}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"preprocess: {views} views from {PRE_RAW_FRAMES} raw frames at {PRE_RAW_HW} "
          f"(depth {PRE_DEPTH_HW}) on {card}: seconds "
          f"{json.dumps({k: round(v, 3) for k, v in sec.items()})}, per raw frame "
          f"{json.dumps({k: round(v, 4) for k, v in line['seconds_per_raw_frame'].items()})}; "
          f"launches {_nonzero(counts)}; checks {[(ok, what) for ok, what in checks]}; modules of "
          f"{list(FOREIGN)} imported: {foreign}", flush=True)
    for ok, what in checks:
        if not ok:
            fail(f"preprocess: {what}")
    if foreign:
        fail(f"the preprocess phase imported {foreign}")
    return line


def nerf_phase(dev):
    """Phase 14: fields.rendering_apply_pallas in nerf mode with codes (K8b
    on h0 = [view PE | features | code], 27 + 256 + 32 = 315 wide) at the
    step's 100,352 samples, forward and backward through autograd, launches
    counted from 0, against rendering_apply (the plain path through
    torch's autograd): rgb at TOL, every parameter, feature and code
    gradient at STEP_TOL, in float32 and bf16; ms of forward + backward
    both ways."""
    from monosdf_torch.kernels import build
    from monosdf_torch.models.fields import (
        RenderingNetConfig,
        init_rendering_net,
        rendering_apply,
        rendering_apply_pallas,
    )

    cfg = RenderingNetConfig(feature_vector_size=256, dims=(256, 256), mode="nerf", d_in=3,
                             multires_view=4, per_image_code=True)
    gen = torch.Generator().manual_seed(SEED + 6)
    ren = init_rendering_net(cfg, gen)
    with torch.no_grad():
        for p in ren.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    ren = ren.to(dev)
    rng = np.random.default_rng(SEED + 6)
    n = CHUNK * 98
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x, d = t(rng.uniform(-1.1, 1.1, (n, 3))), t(rng.normal(size=(n, 3)))
    d = d / d.norm(dim=-1, keepdim=True)
    feat32, target = t(rng.normal(size=(n, 256))), t(rng.uniform(0, 1, (n, 3)))
    idx = torch.from_numpy(rng.integers(0, 4, n)).to(dev)  # the rows of 4 frames

    def run(fn, dt):
        ren.zero_grad(set_to_none=True)
        f = feat32.to(dt or torch.float32).detach().requires_grad_()
        out = fn(ren, cfg, x, d, d, f, ren.embeddings[idx], dtype=dt)["rgb"]
        ((out - target) ** 2).mean().backward()
        grads = {nm: p.grad.detach().clone() for nm, p in ren.named_parameters()}
        return out.detach(), {**grads, "features": f.grad.detach().float()}

    info, ok = {"rows": n, "d0": cfg.layer_dims[0]}, True
    for dname, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        torch.cuda.synchronize()
        build.reset_launch_counts()
        rgb_k, gk = run(rendering_apply_pallas, dt)
        torch.cuda.synchronize()
        counts = {k: v for k, v in build.launches.items() if v}
        rgb_p, gp = run(rendering_apply, dt)
        r_rgb, e_rgb = _ratio([(rgb_k, rgb_p)], *TOL[dname])
        atol, rtol, _ = STEP_TOL[dname]
        worst, worst_name = 0.0, ""
        for nm in gk:
            a, b = gk[nm].float(), gp[nm].float()
            if not torch.isfinite(a).all():
                fail(f"nerf radiance {dname}: gradient {nm} not finite")
            if dname == "float32":
                r = float(((a - b).abs() / (atol + rtol * b.abs())).max())
            else:
                r = float((a - b).abs().max()) / (atol + rtol * float(b.abs().max()))
            if r > worst:
                worst, worst_name = r, nm
        good = counts == {"radiance_mlp": 1, "radiance_mlp_bwd": 1} and max(r_rgb, worst) <= 1.0
        print(f"nerf radiance {dname}: rgb max abs err {e_rgb:.3e} (err / tolerance "
              f"{r_rgb:.3e}); worst gradient err / tolerance {worst:.3e} ({worst_name}); "
              f"launches {counts} {'ok' if good else 'FAIL'}", flush=True)
        ok = ok and good
        info[dname] = {"rgb_max_abs_err": e_rgb, "worst_grad_ratio": worst,
                       "worst_param": worst_name}
        if dname == "bfloat16":
            info["launches"] = {k: counts.get(k, 0) for k in TPU_KERNELS}
    bf = torch.bfloat16
    info["ms_fwd_bwd"] = cuda_ms(lambda: run(rendering_apply_pallas, bf), reps=5)
    info["plain_ms_fwd_bwd"] = cuda_ms(lambda: run(rendering_apply, bf), reps=5)
    print(f"nerf radiance bf16: forward + backward {info['ms_fwd_bwd']:.3f} ms with K8b, "
          f"{info['plain_ms_fwd_bwd']:.3f} ms plain", flush=True)
    del ren
    torch.cuda.empty_cache()
    if not ok:
        fail("the nerf radiance check failed")
    return info


# the probes' main path: one case of each Pallas site of
# scripts/probe_hash_primitives.py at its full size -> (kernel, wave)
PROBE_CASES = {
    "pl_dyngather_ax0_8x128": ("probe_gather", 1),            # P1, axis 0, staged in shared memory
    "pl_dyngather_ax0_8192x128": ("probe_gather", 1),         # P1, axis 0, column slices staged
    "pl_dyngather_ax1_512x128": ("probe_gather", 1),          # P1, axis 1
    "pl_dynslice_store_512x8rows": ("probe_scatter_rows", 1),  # P2
    "smem_alloc_227KB": ("probe_capacity", 4),                 # P3 (P5: the same kernel)
    "pl_rmw_100k_64krows_f32": ("probe_scatter_rows", 4),      # P4
    "pl_rmw_100k_conflict": ("probe_scatter_rows", 4),         # P4, every index 0
    "perrow_dma_64k": ("probe_row_copy", 7),                   # P6, one CTA
    "perrow_dma_64k_per_sm": ("probe_row_copy", 7),            # P6, one CTA per SM
    "strided_permute_kernel": ("probe_strided_permute", 7),    # P7
    "dg_32768r_2048n_bfloat16": ("probe_gather", 8),           # P8, through L2
}
# the case whose numbers stand in the kernels line
PROBE_PRIMARY = {"probe_gather": "pl_dyngather_ax0_8192x128",
                 "probe_scatter_rows": "pl_rmw_100k_64krows_f32",
                 "probe_row_copy": "perrow_dma_64k",
                 "probe_strided_permute": "strided_permute_kernel",
                 "probe_capacity": "smem_alloc_227KB"}
# S and R against their plain versions, entry by entry: |a - b| <= 1e-5 *
# (the sum of the magnitudes of the terms added into the entry): float32
# sums of the same terms in another order (the atomics' order changes from
# run to run); G, M (0/1 permutation) and C exactly
PROBE_SUM_RTOL = 1e-5
# the probe kernels whose calls phase 13 splits into device and host time
SPLIT_KERNELS = ("probe_gather", "probe_scatter_rows", "probe_row_copy", "probe_strided_permute",
                 "probe_capacity")


def _probe_fns():
    from monosdf_torch.kernels import probes

    return {"probe_gather": (probes.gather, probes.gather_plain),
            "probe_scatter_rows": (probes.scatter_rows, probes.scatter_rows_plain),
            "probe_row_copy": (probes.row_copy_sum, probes.row_copy_sum_plain),
            "probe_strided_permute": (probes.strided_permute, probes.strided_permute_plain),
            "probe_capacity": (probes.capacity, probes.capacity_plain)}


def _probe_err(kernel: str, inputs: dict, out, ref):
    """(max abs err, err / tolerance) of a probe kernel's output against its
    plain version's."""
    from monosdf_torch.kernels import probes

    if not torch.isfinite(out).all() or out.shape != ref.shape:
        fail(f"{kernel}: output of shape {tuple(out.shape)} not finite or not {tuple(ref.shape)}")
    err = (out - ref).abs()
    if kernel == "probe_scatter_rows":
        mag = probes.scatter_rows_plain(inputs["offs"], inputs["vals"].abs(), inputs["rows"],
                                        inputs["run"])
        ratio = float((err / (PROBE_SUM_RTOL * mag).clamp_min(1e-30)).max())
    elif kernel == "probe_row_copy":
        mag = inputs["tab"][inputs["idx"].long(), 0].abs().sum()
        ratio = float(err.max() / (PROBE_SUM_RTOL * mag).clamp_min(1e-30))
    else:
        ratio = 0.0 if torch.equal(out, ref) else math.inf
    return float(err.max()), ratio


def _random_like(kernel: str, inputs: dict, gen):
    """The case's inputs with seeded random values in place of the probe's
    constant ones (tables, values, x), indices in range."""
    def randn(t):
        return torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)

    new = dict(inputs)
    if kernel == "probe_gather":
        tbl, idx = inputs["tbl"], inputs["idx"]
        hi = tbl.shape[0] if inputs["axis"] == 0 else 128
        new.update(tbl=randn(tbl), idx=torch.randint(0, hi, idx.shape, generator=gen,
                                                      device=idx.device, dtype=torch.int32))
    elif kernel == "probe_scatter_rows":
        new["vals"] = randn(inputs["vals"])
    elif kernel == "probe_row_copy":
        new["tab"] = randn(inputs["tab"])
    elif kernel == "probe_strided_permute":
        new["x"] = randn(inputs["x"])
    return new


def _probe_bound(kernel: str, inputs: dict, out):
    """(bound_ms, by) of one launch on this run's inputs: each input read
    once, each output written once (G: the table's 32-byte sectors its
    indices reach; R: the index and the sectors that hold the rows' first
    values), and float32 operations at 67 TFLOP/s."""
    if kernel == "probe_gather":
        idx, es = inputs["idx"], inputs["tbl"].element_size()
        wide = idx.long()  # for the sector ids; the kernel reads the int32 index
        lanes = torch.arange(128, device=idx.device)
        flat = wide * 128 + lanes if inputs["axis"] == 0 else \
            torch.arange(idx.shape[0], device=idx.device)[:, None] * 128 + wide
        sectors = int(torch.unique(flat * es // 32).numel())
        return bound_ms(idx.numel() * inputs["reps"], sectors * 32 + nbytes(idx, out),
                        H100_F32_FLOPS)
    if kernel == "probe_scatter_rows":
        return bound_ms(inputs["vals"].numel(), nbytes(inputs["offs"], inputs["vals"], out),
                        H100_F32_FLOPS)
    if kernel == "probe_row_copy":
        rows = int(torch.unique(inputs["idx"]).numel())
        return bound_ms(inputs["idx"].numel(), nbytes(inputs["idx"], out) + rows * 32,
                        H100_F32_FLOPS)
    if kernel == "probe_strided_permute":
        n = inputs["n_out"]
        return bound_ms(2.0 * 9 * n * 128 * 128, (8 * n + 1) * 512 + nbytes(inputs["P"], out),
                        H100_F32_FLOPS)
    return bound_ms(0.0, nbytes(out), H100_F32_FLOPS)


def smem_floor_ms(inputs: dict) -> float:
    """G's shared-memory floor: its reps' reads, reps n 128, each one bank
    access, at 32 a clock on 132 SMs (its bound_ms counts the function's
    bytes, not the reads of the implementation)."""
    return inputs["reps"] * inputs["idx"].numel() / H100_SMEM_READS * 1e3


def row_copy_floor_ms(inputs: dict) -> float:
    """R's copy floor: the 512-byte rows it copies whole, each once, at
    3.35 TB/s (its bound_ms counts only the sectors of their first values)."""
    return inputs["idx"].numel() * 512 / H100_BYTES * 1e3


def _probe_library(kernel: str, inputs: dict):
    """The one PyTorch call that computes the case's function (G: one of its
    reps' gathers; R: the row pick and its sum; M: one einsum over the
    windows x.unfold(0, 9, 8), window r holding rows 8r..8r+8)."""
    from monosdf_torch.kernels import probes

    if kernel == "probe_gather":
        tbl, idx, axis = inputs["tbl"], inputs["idx"].long(), inputs["axis"]
        return lambda: torch.gather(tbl, axis, idx)
    if kernel == "probe_scatter_rows":
        rows = probes.run_rows(inputs["offs"], inputs["run"])
        vals = inputs["vals"].float()
        acc = torch.zeros(inputs["rows"], 128, dtype=torch.float32, device=vals.device)
        return lambda: acc.index_add_(0, rows, vals)
    if kernel == "probe_row_copy":
        tab, idx = inputs["tab"], inputs["idx"].long()
        return lambda: tab[idx, 0].sum()
    if kernel == "probe_capacity":
        return lambda: torch.zeros(inputs["rows"], 128, dtype=torch.float32,
                                   device=inputs["device"])
    x, P, n = inputs["x"], inputs["P"], inputs["n_out"]
    return lambda: torch.einsum("rkb,kl->rl", x.unfold(0, 9, 8)[:n], P)


def probes_phase(dev, results):
    """Phase 15: the probe waves (monosdf_torch/scripts/probe_hash_primitives.py)
    at full size on PROBE_CASES, launches counted from 0 and checked exactly
    (LAUNCHES_PER_CASE per case), each kept output against its plain
    version, each kernel again on random inputs of the case's shapes; per
    case ms (per launch), the probe's rate, bound, plain and library times;
    for G, S, R, M and C the device ms (profiled, queued) and host us of a
    call, for R its copy floor, for G its shared-memory floor.
    Fills results[kernel] for the kernels line; returns the probes line."""
    from monosdf_torch.kernels import build, probes
    from monosdf_torch.scripts import probe_hash_primitives as probe

    waves = sorted({w for _, w in PROBE_CASES.values()})
    keep = {}
    torch.cuda.synchronize()
    build.reset_launch_counts()
    for w in waves:  # the main path: the probe's own entry points
        only = tuple(c for c, (_, wave) in PROBE_CASES.items() if wave == w)
        probe.WAVES[w](dev, only=only, keep=keep)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    expect = dict.fromkeys(counts, 0)
    for kernel, _ in PROBE_CASES.values():
        expect[kernel] += probe.LAUNCHES_PER_CASE
    print(f"probes: launches {({k: v for k, v in counts.items() if v})} (expected "
          f"{({k: v for k, v in expect.items() if v})})", flush=True)
    if counts != expect:
        fail(f"probes launch counts {counts} != {expect}")
    if set(keep) != set(PROBE_CASES):
        fail(f"probes: kept cases {sorted(keep)} != {sorted(PROBE_CASES)}")

    fns, gen, ok = _probe_fns(), torch.Generator(device=dev).manual_seed(SEED + 7), True
    cases = {}
    for case, (kernel, wave) in PROBE_CASES.items():
        wrap, plain = fns[kernel]
        k = keep[case]
        inputs = k["inputs"]
        err, ratio = _probe_err(kernel, inputs, k["out"], plain(**inputs))
        rnd = _random_like(kernel, inputs, gen)
        err_r, ratio_r = _probe_err(kernel, rnd, wrap(**rnd), plain(**rnd))
        torch.cuda.synchronize()
        good = max(ratio, ratio_r) <= 1.0
        ok = ok and good
        print(f"check {case:27s} ({kernel}) max_abs_err {err:.3e} / random inputs {err_r:.3e}; "
              f"worst err / tolerance {max(ratio, ratio_r):.3e} {'ok' if good else 'FAIL'}",
              flush=True)
        b, by = _probe_bound(kernel, inputs, k["out"])
        cases[case] = {
            "kernel": kernel, "wave": wave,
            **{kk: k[kk] for kk in ("ms", "ms_per_rep", "rate", "rate_unit")},
            "bound_ms": b, "bound_by": by,
            "plain_ms": cuda_ms(lambda: plain(**inputs), reps=3, warmup=1),
            "library_ms": cuda_ms(_probe_library(kernel, inputs), reps=5),
            "max_abs_err": max(err, err_r), "err_over_tolerance": max(ratio, ratio_r)}
        if kernel in SPLIT_KERNELS:  # a call's device / host split
            call = lambda: wrap(**inputs)
            cases[case].update(device_ms=device_ms(call, kernel, reps=5),
                               queued_ms=queued_ms(call), host_us=host_us(call))
        if kernel == "probe_row_copy":
            cases[case]["copy_floor_ms"] = row_copy_floor_ms(inputs)
        if kernel == "probe_gather":
            cases[case]["smem_floor_ms"] = smem_floor_ms(inputs)
    lim = probes.device_limits(dev)
    shown = ("ms", "device_ms", "queued_ms", "host_us", "bound_ms", "copy_floor_ms",
             "smem_floor_ms", "plain_ms", "library_ms")
    print(f"probe cases (ms per launch): {json.dumps({c: {kk: v[kk] for kk in shown if kk in v} for c, v in cases.items()})}",
          flush=True)
    for kernel, case in PROBE_PRIMARY.items():
        c = cases[case]
        results[kernel] = {
            "case": case, "replaces_sites": PROBE_SITES[kernel],
            "max_abs_err": max(v["max_abs_err"] for v in cases.values() if v["kernel"] == kernel),
            **{kk: c[kk] for kk in ("ms", "device_ms", "queued_ms", "host_us", "plain_ms",
                                    "bound_ms", "bound_by", "copy_floor_ms", "smem_floor_ms",
                                    "library_ms")
               if kk in c},
            "cases": [n for n, v in cases.items() if v["kernel"] == kernel]}
    torch.cuda.empty_cache()
    if not ok:
        fail("a probe kernel disagrees with its plain version beyond the stated tolerance")
    return {"launches": counts, "launches_per_case": probe.LAUNCHES_PER_CASE,
            "device_limits": lim, "cases": cases}


# the data-parallel phase (ddp_phase): the port's DDP step (monosdf_torch/
# parallel) at world size 1 over NCCL against the plain step, two ranks on
# the one card, and the flagship dryrun
DDP_WARMUP, DDP_TIMED = 3, 10
DDP_MODELS = {"mlp": PER_STEP, "grids": PER_STEP_GRIDS}
# the world-size-2 check against its serial emulation: JAX's bar
# (tests/test_train.py:252); two ranks' gradients average exactly in float32
# (g/2 is exact and a sum of two is commutative), so the bar sits far above
# what a right average gives
DDP_SERIAL_ATOL = 1e-6
# the grid model's table gradient, DDP step against the plain step from one
# state, per tensor |a - b| <= DDP_TABLE_RTOL max|b|: K5's float32 atomic
# sums of the same terms in another order (ENCODE_BWD_TOL's float32 rtol)
DDP_TABLE_RTOL = 1e-4
DDP_DEADLINE_S = 240.0  # a spawn of two ranks is joined within this, then killed
DDP_NCCL_DEADLINE_S = 60.0  # NCCL's two ranks on one card answer (refuse) within this


def _param_bits_differ(a, b) -> list:
    """The names of the parameters whose bits differ between two models."""
    pb = dict(b.named_parameters())
    return [n for n, p in a.named_parameters() if not bits_equal(p.detach(), pb[n].detach())]


def _sync_state(dst, src, generators):
    """(model, optimizer) ``dst`` set to ``src``'s parameters and Adam state,
    and each generator of ``generators[1:]`` to the first's state."""
    import copy

    with torch.no_grad():
        for p, q in zip(dst[0].parameters(), src[0].parameters()):
            p.copy_(q)
    dst[1].adam.load_state_dict(copy.deepcopy(src[1].adam.state_dict()))
    for g in generators[1:]:
        g.set_state(generators[0].get_state())


def _ddp_ws1(dev, which: str, lines: dict) -> dict:
    """World size 1 over NCCL: the DDP step and the plain step (cli/train.py's)
    from the same weights on the same batches, draws from equal generators,
    in turns; launches per DDP step as the plain step's; ms a step both
    ways; a profile of each (busy share, the NCCL kernels' device time);
    DDP's buckets. The MLP model: the parameters bit-equal after every step.
    The grid model: K5 adds the table's gradient with float atomics, so two
    plain steps give other table bits now and then, and every parameter
    follows from the next step on; so each step starts the DDP model and a
    second plain model from the first's state, every other parameter is
    bit-equal after it, and the table's gradient within DDP_TABLE_RTOL of
    the plain step's (the second plain step's spread printed beside)."""
    from monosdf_torch.cli.train import ray_batches
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.kernels import build
    from monosdf_torch.losses import LossConfig
    from monosdf_torch.models.monosdf import init_monosdf
    from monosdf_torch.parallel import ddp
    from monosdf_torch.train import OptimConfig, make_optimizer, make_train_step

    per_step = DDP_MODELS[which]
    atomic = per_step["hash_encode_bwd"] > 0
    cfg = path_config(which, "bfloat16")
    loss_cfg = LossConfig(if_gamma_loss=cfg.rendering.if_hdr)
    ocfg = OptimConfig(grid_mode=cfg.implicit.use_grid)
    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    batches = ray_batches(scene, np.random.default_rng(SEED + 20), DDP_WARMUP + DDP_TIMED,
                          CHUNK, dev)
    runs = {}  # tag -> (model, optimizer, step function, module the step takes, generator)
    for tag in ("plain", "plain2", "ddp") if atomic else ("plain", "ddp"):
        model = init_monosdf(cfg, seed=SEED, device=dev)
        opt = make_optimizer(ocfg, model.named_parameters())
        if tag == "ddp":
            runs[tag] = (model, opt, ddp.make_parallel_train_step(cfg, loss_cfg, opt),
                         ddp.replicate(model), ddp.rank_generator(SEED, 0, dev))
        else:
            runs[tag] = (model, opt, make_train_step(cfg, loss_cfg, opt), model,
                         torch.Generator(device=dev).manual_seed(SEED))
    what = f"ddp ws1 {which}"
    times, counts, table = {"plain": [], "ddp": []}, {}, {"err": 0.0, "spread": 0.0}
    for i, b in enumerate(batches):
        if atomic and i:
            for tag in ("plain2", "ddp"):
                _sync_state(runs[tag][:2], runs["plain"][:2],
                            [runs["plain"][4], runs[tag][4]])
        for tag, (model, opt, fn, module, gen) in runs.items():
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = fn(module, b, generator=gen)
            torch.cuda.synchronize()
            if i >= DDP_WARMUP and tag in times:
                times[tag].append((time.perf_counter() - t0) * 1e3)
            got = launch_counts()
            if got != per_step:
                fail(f"{what} {tag} step {i}: launches {_nonzero(got)} != {_nonzero(per_step)}")
            if tag == "ddp":
                for k, v in got.items():
                    counts[k] = counts.get(k, 0) + v
            if not math.isfinite(float(metrics["loss"])):
                fail(f"{what} {tag} step {i}: non-finite loss")
        ref = dict(runs["plain"][0].named_parameters())
        differ = [n for n in _param_bits_differ(runs["ddp"][0], runs["plain"][0])
                  if not (atomic and "encoding" in n)]
        if differ:
            worst = max(float((p.detach().float() - ref[n].detach().float()).abs().max())
                        for n, p in runs["ddp"][0].named_parameters() if n in differ)
            fail(f"{what} step {i}: parameters not bit-equal to the plain step's: {differ} "
                 f"(max abs {worst:.3e})")
        if atomic:
            name = next(n for n in ref if "encoding" in n)
            g_ref = ref[name].grad
            scale = float(g_ref.abs().max())
            for tag, key in (("ddp", "err"), ("plain2", "spread")):
                d = float((dict(runs[tag][0].named_parameters())[name].grad - g_ref).abs().max())
                # (a zero gradient, as at the geometric init's first step, must stay zero)
                table[key] = max(table[key], d / scale if scale else (math.inf if d else 0.0))
            if table["err"] > DDP_TABLE_RTOL:
                fail(f"{what} step {i}: the table's gradient {table['err']:.3e} of its largest "
                     f"entry from the plain step's (bar {DDP_TABLE_RTOL})")
    model, _, step, ddp_model, g_ddp = runs["ddp"]
    plain_model, _, plain_step, _, g_plain = runs["plain"]
    info = {"steps": len(batches), "warmup": DDP_WARMUP,
            "bit_equal": "every parameter, every step" if not atomic else
            "every parameter but the table, each step from the plain step's state",
            "ms_per_step": float(np.mean(times["ddp"])),
            "plain_ms_per_step": float(np.mean(times["plain"])),
            "ms_per_step_each": times["ddp"], "plain_ms_per_step_each": times["plain"],
            "launches_per_step": _nonzero(per_step), "loss_last": float(metrics["loss"])}
    if atomic:
        info["table_grad_rel_err"] = table["err"]
        info["table_grad_rel_spread_plain"] = table["spread"]
    log = ddp_model._get_ddp_logging_data()
    buckets = [int(v) for v in str(log.get("bucket_sizes", "")).split(",") if v.strip()]
    info.update(backend=log.get("backend_name"), buckets=len(buckets),
                bucket_bytes=buckets, bytes_reduced_per_step=sum(buckets),
                num_buckets_reduced=log.get("num_buckets_reduced"),
                parameter_bytes=log.get("total_parameter_size_bytes"))
    prof_ddp = _profile(lambda: step(ddp_model, batches[0], generator=g_ddp), 1, what)
    prof_plain = _profile(lambda: plain_step(plain_model, batches[0], generator=g_plain), 1,
                          what + " plain")
    keys = ("ms", "device_busy_ms", "busy_share", "nccl_ms", "nccl_events", "nccl_host_events",
            "other_top_ms", "host_top_ms")
    info["profile"] = {k: prof_ddp[k] for k in keys}
    info["profile_plain"] = {k: prof_plain[k] for k in keys}
    info["allreduce_device_ms_per_step"] = prof_ddp["nccl_ms"]
    print(f"{what}: {len(batches)} steps in turns with the plain step, bit-equal: "
          f"{info['bit_equal']}; table gradient {table}; "
          f"{info['ms_per_step']:.3f} ms/step (plain {info['plain_ms_per_step']:.3f}); "
          f"{info['buckets']} buckets, {info['bytes_reduced_per_step']} bytes a step; NCCL "
          f"{prof_ddp['nccl_ms']:.4f} ms device a step ({prof_ddp['nccl_events']} device and "
          f"{prof_ddp['nccl_host_events']} host events); busy {prof_ddp['device_busy_ms']:.3f} "
          f"of {prof_ddp['ms']:.3f} ms (plain {prof_plain['device_busy_ms']:.3f} of "
          f"{prof_plain['ms']:.3f})", flush=True)
    lines[which] = info
    del runs, plain_model, model, ddp_model
    torch.cuda.empty_cache()
    return counts


def _ddp_nccl_two_ranks(rank: int, world_size: int, store_dir: str):
    """A rank of NCCL's two-ranks-on-one-card check: its answer to one
    all-reduce, in <store_dir>/nccl_<rank>.txt."""
    from monosdf_torch.parallel import ddp

    try:
        ddp.init_group(rank, world_size, store_dir, "cuda:0", backend="nccl")
        t = torch.ones(4, device="cuda:0")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        answer = f"accepted: {t.tolist()}"
    except Exception as e:  # the refusal is this check's expected answer
        answer = f"refused: {type(e).__name__}: {e}"
    with open(os.path.join(store_dir, f"nccl_{rank}.txt"), "w") as f:
        f.write(answer)
    os._exit(0)  # no teardown of a communicator that may have failed to form


def _ddp_gloo_rank(rank: int, world_size: int, store_dir: str):
    """A rank of the two-ranks-on-one-card step: gloo over CUDA tensors,
    the float32 MLP model through the kernels, one DDP step on its chunk
    with its fixed draws; its averaged gradients and parameters saved."""
    from monosdf_torch.cli.train import ray_batches
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.kernels import build
    from monosdf_torch.losses import LossConfig
    from monosdf_torch.parallel import ddp
    from monosdf_torch.train import OptimConfig, make_optimizer

    dev = ddp.init_group(rank, world_size, store_dir, "cuda:0", backend="gloo")
    cfg = path_config("mlp", "float32")
    model = perturbed_model(cfg, dev)
    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    (batch,) = ray_batches(scene, np.random.default_rng(SEED + 30), 1, 2 * CHUNK, dev)
    opt = make_optimizer(OptimConfig(), model.named_parameters())
    step = ddp.make_parallel_train_step(cfg, LossConfig(), opt)
    build.reset_launch_counts()
    metrics = step(ddp.replicate(model), ddp.shard_batch(batch, rank, world_size),
                   generator=torch.Generator(device=dev).manual_seed(SEED + 40 + rank))
    torch.cuda.synchronize()
    torch.save({"grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
                "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                "loss": float(metrics["loss"]), "launches": launch_counts()},
               os.path.join(store_dir, f"gloo_{rank}.pt"))


def _ddp_ws2(dev) -> dict:
    """World size 2 on the one card: NCCL's answer to two ranks on one
    device, then the gloo step (float32 MLP model, kernels) against its
    serial emulation (each rank's chunk on the card alone in this process,
    the gradients averaged, one Adam step)."""
    import tempfile

    from monosdf_torch.cli.train import ray_batches
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.losses import LossConfig
    from monosdf_torch.parallel import ddp
    from monosdf_torch.train import OptimConfig, make_optimizer
    from monosdf_torch.train.step import step_losses

    info = {}
    with tempfile.TemporaryDirectory(prefix="ddp-nccl-") as store:
        t0 = time.perf_counter()
        try:
            ddp.spawn(_ddp_nccl_two_ranks, 2, store_dir=store, timeout_s=DDP_NCCL_DEADLINE_S)
        except TimeoutError as e:
            fail(f"ddp ws2: NCCL with two ranks on one card gave no answer: {e}")
        answers = [open(os.path.join(store, f"nccl_{r}.txt")).read() for r in range(2)]
        info["nccl_two_ranks_one_card"] = answers
        info["nccl_check_s"] = time.perf_counter() - t0
    print(f"ddp ws2: NCCL with two ranks on cuda:0: {answers}", flush=True)

    with tempfile.TemporaryDirectory(prefix="ddp-gloo-") as store:
        t0 = time.perf_counter()
        ddp.spawn(_ddp_gloo_rank, 2, store_dir=store, timeout_s=DDP_DEADLINE_S)
        info["gloo_step_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(store, f"gloo_{r}.pt")) for r in range(2)]
    cfg = path_config("mlp", "float32")
    scene = make_synthetic_sphere_scene(n_images=4, img_res=64)
    (batch,) = ray_batches(scene, np.random.default_rng(SEED + 30), 1, 2 * CHUNK, dev)
    grads = []
    for r in range(2):
        model = perturbed_model(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 40 + r)
        step_losses(model, cfg, LossConfig(), ddp.shard_batch(batch, r, 2), 0,
                    generator=gen)["loss"].backward()
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
    model = perturbed_model(cfg, dev)
    adam, schedule = make_optimizer(OptimConfig(), model.named_parameters())
    for n, p in model.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2
    adam.step()
    schedule.step()
    err_g = err_p = 0.0
    for n, p in model.named_parameters():
        for r in range(2):
            err_g = max(err_g, float((ranks[r]["grads"][n].to(dev) - p.grad).abs().max()))
            err_p = max(err_p, float((ranks[r]["params"][n].to(dev) - p.detach()).abs().max()))
    same = all(torch.equal(v, ranks[1]["params"][n]) for n, v in ranks[0]["params"].items())
    info.update(backend="gloo", dtype="float32", rays_per_rank=CHUNK,
                grad_max_abs_err=err_g, update_max_abs_err=err_p, ranks_bit_equal=same,
                loss=ranks[0]["loss"], launches_per_rank=_nonzero(ranks[0]["launches"]),
                atomics="K5 (hash_encode_bwd) adds with float atomics: the grid model is not run "
                        "here; the MLP path's kernels add in a fixed order")
    print(f"ddp ws2 gloo on cuda:0: averaged gradients {err_g:.3e} and updated parameters "
          f"{err_p:.3e} from the serial emulation (bar {DDP_SERIAL_ATOL}); ranks equal {same}; "
          f"launches a rank {info['launches_per_rank']}", flush=True)
    for r in ranks:
        if r["launches"] != PER_STEP:
            fail(f"ddp ws2: a rank's launches {_nonzero(r['launches'])} != {_nonzero(PER_STEP)}")
    if not same or err_g > DDP_SERIAL_ATOL or err_p > DDP_SERIAL_ATOL:
        fail("ddp ws2: the two-rank step is not the serial emulation's")
    return info


def ddp_phase(dev) -> dict:
    """The data-parallel phase: (a) world size 1 over NCCL, the MLP and grid
    models (_ddp_ws1); (b) two ranks on the one card (_ddp_ws2); (c)
    parallel.dryrun_ddp(1), the flagship program at full size, launching
    exactly the kernels config.routed_kernels names. launches: the DDP steps
    of (a) and the dryrun's."""
    import tempfile

    from monosdf_torch.kernels import build
    from monosdf_torch.models.monosdf import routed_kernels
    from monosdf_torch.parallel import ddp, dryrun

    t_phase = time.perf_counter()
    line = {"ws1": {}}
    counts = dict.fromkeys(build.KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="ddp-ws1-") as store:
        ddp.init_group(0, 1, store, dev)  # NCCL, the production backend
        try:
            for which in DDP_MODELS:
                for k, v in _ddp_ws1(dev, which, line["ws1"]).items():
                    if k in counts:
                        counts[k] += v
        finally:
            torch.distributed.destroy_process_group()
    line["ws2"] = _ddp_ws2(dev)

    build.reset_launch_counts()
    t0 = time.perf_counter()
    loss = dryrun.dryrun_ddp(1, device=dev, rays_per_rank=CHUNK)
    torch.cuda.synchronize()
    got = launch_counts()
    routed = set(routed_kernels(dryrun.flagship_config()))
    line["dryrun"] = {"loss": loss, "s": time.perf_counter() - t0, "rays": CHUNK,
                      "launches": _nonzero(got), "routed": sorted(routed)}
    print(f"dryrun_ddp(1) on the card: loss {loss:.5f}, launches {_nonzero(got)} (routed "
          f"{sorted(routed)})", flush=True)
    if set(_nonzero(got)) != routed or not math.isfinite(loss):
        fail(f"dryrun_ddp(1): launches {_nonzero(got)} not the routed kernels {sorted(routed)}")
    for k, v in got.items():
        if k in counts:
            counts[k] += v
    line["launches"] = counts
    line["s"] = time.perf_counter() - t_phase
    print(f"ddp phase: {line['s']:.1f} s", flush=True)
    return line


def main(argv):
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from monosdf_torch.cli.eval import bench_mlp_config
    from monosdf_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run full float32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.nvcc_path()})", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas {name}: {line.strip()}")
    hgmma = sass_counts(TENSOR_CORE_LIBS, "HGMMA")
    print(f"HGMMA instructions in SASS: {json.dumps(hgmma)}", flush=True)
    if not all(hgmma.values()):
        fail(f"a tensor-core library has no HGMMA in its SASS: {hgmma}")
    # R copies each row by its own bulk copy, M its x window and P (cp.async.bulk: UBLKCP)
    bulk = sass_counts(("probe_row_copy", "probe_strided_permute"), "UBLKCP")
    print(f"UBLKCP instructions in SASS: {json.dumps(bulk)}", flush=True)
    if not all(bulk.values()):
        fail(f"R's or M's library has no bulk copy (UBLKCP) in its SASS: {bulk}")
    # C writes its output by bulk stores (cp.async.bulk.global.shared::cta: UBLKCP.G.S)
    bulk_store = sass_counts(("probe_capacity",), "UBLKCP.G.S")
    print(f"UBLKCP.G.S instructions in SASS: {json.dumps(bulk_store)}", flush=True)
    if not all(bulk_store.values()):
        fail(f"C's library has no bulk store (UBLKCP.G.S) in its SASS: {bulk_store}")

    if "--ddp" in argv:
        print(json.dumps({"ddp": ddp_phase(dev)}))
        return
    if "--witness" in argv:
        groups = [tuple(int(v) for v in g.split(",")) for g in argv[argv.index("--witness") + 1:]]
        print(json.dumps({"witness_study": witness_study(dev, groups)}))
        return
    cfg = bench_mlp_config("bfloat16")
    model = perturbed_model(cfg, dev)
    results = kernel_checks(model, cfg, dev)
    training_kernel_checks(model, cfg, dev, results)
    del model
    torch.cuda.empty_cache()
    grid_kernel_checks(dev, results)
    radiance_kernel_checks(dev, results)
    for name in build.KERNELS:
        if build.SOURCE_OF[name] in hgmma:
            results[name]["sass_hgmma"] = hgmma[build.SOURCE_OF[name]]
    if "--kernels" in argv:
        probes_phase(dev, results)
        for name in bulk:
            results[name]["sass_ublkcp"] = bulk[name]
        results["probe_capacity"]["sass_ublkcp_g_s"] = bulk_store["probe_capacity"]
        print(json.dumps(results))
        return
    # the main paths, each render and each set of timed steps counted from 0
    lines = {}
    for which in PATHS:
        suffix = PATHS[which][0]
        rinfo, runs = render_phase(dev, which)
        tinfo, train_run = train_phase(dev, which)
        # render profiles of the bench models and the union model (K3, and
        # K8a with 'pallas'); one step of every model
        profile_phase(runs if which != "pe" else {}, rinfo, train_run, tinfo,
                      suffix.replace("_", " "))
        lines[f"render{suffix}"], lines[f"train{suffix}"] = rinfo, tinfo
        del runs, train_run
        torch.cuda.empty_cache()
    lines["scene"], (union_model, union_cfg) = scene_phase(dev)
    lines["mesh"] = mesh_phase(dev, union_model, union_cfg)
    del union_model
    torch.cuda.empty_cache()
    lines.update(conf_phase(dev))
    lines.update(quality_phase(dev))
    lines["preprocess"] = preprocess_phase(dev)
    lines["nerf_radiance"] = nerf_phase(dev)
    lines["probes"] = probes_phase(dev, results)
    lines["ddp"] = ddp_phase(dev)
    for name in bulk:
        results[name]["sass_ublkcp"] = bulk[name]
    results["probe_capacity"]["sass_ublkcp_g_s"] = bulk_store["probe_capacity"]

    kernels = []
    for name in build.KERNELS:
        r = results[name]
        # the main paths' runs, each counted from 0: the bf16 renders (16
        # chunks each), the timed training steps of every model, the scene's
        # and the mesh phase's runs, the three conf runs (train, resume and
        # eval), the nerf check, the probes
        runs_n = {f"launches_{tag}": line["launches"][name] for tag, line in lines.items()
                  if "launches" in line}
        per = {}
        for which, (suffix, per_chunk, per_step) in PATHS.items():
            per[f"launches_per_chunk{suffix}"] = per_chunk[name]
            per[f"launches_per_step{suffix}"] = per_step[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"monosdf_torch/csrc/{build.SOURCE_OF[name]}.cu",
            "replaces": TPU_KERNELS[name],
            "launches": sum(runs_n.values()),
            **runs_n,
            "launches_quality": sum(v for k, v in runs_n.items()
                                    if k.startswith("launches_quality_")),
            **per,
            "library_ms": None,
            **r,
            "kernel_ms": r["ms"],
        })
    for tag, line in lines.items():
        print(json.dumps({"quality" if tag.startswith("quality_") else tag: line}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

"""Micro-benchmark of K2 (the SDF MLP with its spatial gradient) forward and
forward+backward on the card (the port of scripts/bench_sdf_grad_kernel.py),
at the ScanNet-MLP work-budget shape (~100k points, 8x256 MLP with a skip
at 4, PE(6), 256-d features):

    python -m monosdf_torch.scripts.bench_sdf_grad_kernel [--n 100352] [--iters 20] [--f32] [--device cpu]

The weights are the bench model's (``cli/eval.py bench_config(False)``,
seed 0; weight norm resolved), the points ``--n`` uniform draws in
[-1, 1)^3 (``default_rng(0)``), bf16 operands (``--f32``: float32). The
forward is K2f's training variant (Z saved; unclamped, as the JAX script's
call), the forward+backward K2f and K2b through ``kernels/sdf_grad.py``'s
autograd Function on the JAX script's loss ``sum(sdf^2) + sum(g^2)``, its
gradient taken in every weight and bias. Each is called once, then
``--iters`` times from the host clock to a synchronise. Prints ONE JSON
line: the JAX script's keys ``n``, ``dtype``, ``save_z`` (always true),
``fwd_ms``, ``fwd_bwd_ms``, ``fwd_tflops`` and ``fwd_bwd_tflops`` (its
formula: n x 4 rows x 8 layers x 256^2 x 2 FLOP forward, 4x that forward
and backward), and ``bound_ms_fwd``/``bound_ms_fwd_bwd`` by PERF.md §3's
rule (the larger of the bytes each input read once and each output written
once over 3.35 TB/s and the FLOP over 989 TFLOP/s bf16 or 67 float32; the
FLOP of the stacked primal and 3 tangent rows through every layer, the
backward's two products a layer more; the bytes ``chip_smoke.py``'s K2f
and K2b bounds count), with ``device``.

Flags of scripts/bench_sdf_grad_kernel.py: ``--n``, ``--iters`` and
``--f32`` have their counterparts. ``--blocks`` and ``--sched`` choose the
TPU kernel's block sizes and schedules: the port's kernels have fixed
tiles and one schedule, so they are left out; so is ``--no_save_z``, as
the port has no backward that recomputes the forward (K2b reads the saved
Z). The port adds ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..cli.eval import bench_config
from ..device import resolve_device
from ..kernels import build
from ..kernels.sdf_grad import sdf_mlp_with_grad
from ..models.fields import effective_linear_weights
from ..models.monosdf import init_monosdf

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 (NVIDIA data sheet, SXM, 700 W)
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bytes/s


def bound_ms(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / H100_BYTES) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100352)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all()
    cfg = bench_config(False).implicit
    with torch.no_grad():
        ws, bs = effective_linear_weights(init_monosdf(bench_config(False), seed=0,
                                                       device=dev).implicit)
    ws = [w.detach().requires_grad_(True) for w in ws]
    bs = [b.detach().requires_grad_(True) for b in bs]
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (args.n, 3))
                         .astype(np.float32)).to(dev)
    dtype = None if args.f32 else torch.bfloat16
    skip = tuple(cfg.skip_in)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn) -> float:
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / args.iters * 1e3

    def fwd():
        with torch.no_grad():
            return sdf_mlp_with_grad(ws, bs, x, cfg.multires, skip, dtype, save_z=True)

    def fwd_bwd():
        sdf, _, g = sdf_mlp_with_grad(ws, bs, x, cfg.multires, skip, dtype)
        loss = torch.sum(sdf[:, 0] ** 2) + torch.sum(g ** 2)
        return torch.autograd.grad(loss, [*ws, *bs])

    ms_f, ms_fb = timed(fwd), timed(fwd_bwd)
    n = args.n
    gflop_f = n * 4 * 8 * 256 * 256 * 2 / 1e9
    # the bounds: chip_smoke.py's K2f-train and K2b counts at these shapes
    act = 4 if args.f32 else 2
    kin_l, n_l = ws[-1].shape
    F = n_l - 1
    mm = lambda wl, rows: 2.0 * rows * sum(w.shape[0] * w.shape[1] for w in wl)
    fwd_flops = mm(ws[:-1], 4 * n) + 2.0 * n * kin_l * n_l + 2.0 * 3 * n * kin_l
    prop_flops = mm(ws[1:-1], 4 * n) + 2.0 * n * kin_l * n_l + 2.0 * 3 * n * kin_l
    w_bytes = sum(t.numel() * 4 for t in (*ws, *bs))
    z_bytes = sum(4 * n * w.shape[1] * act for w in ws[:-1])
    f_bytes = n * (3 * 4 + 4 + F * act + 3 * 4) + z_bytes + w_bytes
    b_bytes = n * (3 * 4 + (1 + F + 3) * act) + z_bytes + 2 * w_bytes
    peak = H100_F32_FLOPS if args.f32 else H100_BF16_FLOPS
    line = {
        "n": n, "dtype": "float32" if args.f32 else "bfloat16", "save_z": True,
        "fwd_ms": ms_f, "fwd_bwd_ms": ms_fb,
        "fwd_tflops": gflop_f / ms_f, "fwd_bwd_tflops": 4 * gflop_f / ms_fb,
        "bound_ms_fwd": bound_ms(fwd_flops, f_bytes, peak),
        "bound_ms_fwd_bwd": bound_ms(2 * fwd_flops + prop_flops, f_bytes + b_bytes, peak),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

"""How often the SDF trunk kernels' bf16 roundings land off a float64 reference.

    python -m monosdf_torch.scripts.rounding_parity                 # K2f, the union model, 100,352 points
    python -m monosdf_torch.scripts.rounding_parity --model mlp --n 4096
    python -m monosdf_torch.scripts.rounding_parity --model grids   # K7f, the grid model

K2f and K7f round every matmul operand and every activation they store to
bf16 and sum in float32 (``kernels/sdf_grad.py``, ``kernels/sdf_grad_grid.py``).
The reference here computes the same function with the same rounding points
and float64 sums, so a bf16 value that differs from it was moved by the
rounding of a float32 sum. For the training variant (the tensor-core kernel,
which writes Z), the render chunk's kernel (no Z: K2f's CUDA-core kernel,
which gives its SIMT kernel's bits; K7f's tensor-core kernel) and the plain
version, on seeded points in the 1.1 box,
without the sphere clamp, with the model's seeded init plus 0.01 noise (as
``chip_smoke.py`` perturbs it); the grid model's layer-0 input [PE |
features] and its tangents come from its hash encode
(``fields.grid_trunk_input``). The script prints ONE JSON line:
per hidden layer the share of Z entries off the reference (for the paths
that write Z), the mean and max abs error of sdf, grad and the features,
and on the card each path's ms per call (CUDA events). It runs on the card,
and raises without one unless ``--device cpu`` asks for the CPU, where every
path is the plain version.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ..cli.eval import bench_grids_config, bench_mlp_config, union_codes_config
from ..device import resolve_device
from ..kernels import sdf_grad_grid as k7
from ..kernels.sdf_grad import gate100, pe_with_tangents, sdf_mlp_with_grad, sdf_mlp_with_grad_plain
from ..models.fields import effective_linear_weights, grid_trunk_input
from ..models.monosdf import init_monosdf

CONFIGS = {"union": union_codes_config, "mlp": bench_mlp_config, "grids": bench_grids_config}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def reference64(ws, bs, A0, N: int, skip_in=()):
    """The trunk at its bf16 rounding points with float64 sums over the
    stacked layer-0 input A0 (4N, d0) (primal rows, then the three tangents'):
    (sdf, feat, grad) float64 and the hidden layers' Z at bf16, (4, N,
    out_l)."""
    A0 = A0.double()
    A, zs = A0, []
    for l in range(len(ws) - 1):
        if l in skip_in:
            A = torch.cat([A, A0], dim=-1) / math.sqrt(2.0)
        Z = _bf16(A) @ _bf16(ws[l].double())
        zp = Z[:N] + bs[l].double()
        zs.append(torch.cat([zp, Z[N:]]).to(torch.bfloat16).reshape(4, N, -1))
        h, s = gate100(zp)
        A = _bf16(torch.cat([h, s.repeat(3, 1) * Z[N:]]))
    if (len(ws) - 1) in skip_in:
        A = torch.cat([A, A0], dim=-1) / math.sqrt(2.0)
    zp = _bf16(A[:N]) @ _bf16(ws[-1].double()) + bs[-1].double()
    zt = _bf16(A[N:]) @ _bf16(ws[-1][:, :1].double())
    return zp[:, :1], zp[:, 1:], zt.reshape(3, N).T, zs


def _ms(fn, dev) -> float | None:
    """ms per call of fn on the card (CUDA events, after a warm-up); None on
    the CPU."""
    if dev.type != "cuda":
        return None
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def measure(model: str = "union", n: int = 100_352, device=None, seed: int = 0) -> dict:
    dev = resolve_device(device)
    cfg = CONFIGS[model]("bfloat16")
    imp = cfg.implicit
    net = init_monosdf(cfg, seed=seed, device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    bf = torch.bfloat16
    result = {"model": model, "points": n, "device": str(dev)}
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() > 0:
                p.add_(0.01 * torch.randn(p.shape, generator=gen).to(dev))
        ws, bs = effective_linear_weights(net.implicit)
        x = np.random.default_rng(seed).uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        if model == "grids":  # K7f over the hash encode's input
            a0 = grid_trunk_input(net.implicit, imp, x).contiguous()
            ref = reference64(ws, bs, a0.reshape(4 * n, -1), n)
            calls = {
                "train_kernel": lambda: k7._forward(ws, bs, a0, bf, True),
                "chunk_kernel": lambda: k7._forward(ws, bs, a0, bf, False),
                "plain": lambda: k7.sdf_mlp_with_grad_in_plain(ws, bs, a0, bf, True),
            }
            z_at = 3
        else:  # K2f over the raw points
            args = (ws, bs, x, imp.multires, imp.skip_in, bf)
            emb, tang = pe_with_tangents(x.double(), imp.multires)
            ref = reference64(ws, bs, torch.cat([emb, tang]), n, imp.skip_in)
            calls = {
                "train_kernel": lambda: sdf_mlp_with_grad(*args, save_z=True),
                "chunk_kernel": lambda: sdf_mlp_with_grad(*args),
                "plain": lambda: sdf_mlp_with_grad_plain(*args, save_z=True),
            }
            z_at = 4
        for name, call in calls.items():
            out = call()
            r = {}
            for what, i in (("sdf", 0), ("grad", 2), ("feat", 1)):
                e = (out[i].double() - ref[i]).abs()
                r[f"{what}_mean_abs_err"] = float(e.mean())
                r[f"{what}_max_abs_err"] = float(e.max())
            if len(out) > z_at:
                r["z_off_share"] = [float((z != zr).float().mean())
                                    for z, zr in zip(out[z_at], ref[3])]
            del out
            r["ms"] = _ms(call, dev)
            result[name] = r
    if dev.type == "cuda":
        result["card"] = torch.cuda.get_device_name(dev)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(CONFIGS), default="union")
    ap.add_argument("--n", type=int, default=100_352, help="points (the render chunk's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.model, a.n, a.device, a.seed)))


if __name__ == "__main__":
    main()

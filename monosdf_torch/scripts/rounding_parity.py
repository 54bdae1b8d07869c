"""How often K2f's bf16 roundings land off a float64 reference.

    python -m monosdf_torch.scripts.rounding_parity                 # the union model, 100,352 points
    python -m monosdf_torch.scripts.rounding_parity --model mlp --n 4096

K2f rounds every matmul operand and every activation it stores to bf16 and
sums in float32 (``kernels/sdf_grad.py``). The reference here computes the
same function with the same rounding points and float64 sums, so a bf16
value that differs from it was moved by the rounding of a float32 sum. For
K2f's training variant (the tensor-core kernel, which writes Z), its render
chunk (no Z: the SIMT kernel) and the plain version, on seeded points in
the 1.1 box, without the sphere clamp, with the model's seeded init plus
0.01 noise (as ``chip_smoke.py`` perturbs it), the script prints ONE JSON
line: per hidden layer the share of Z entries off the reference (for the
paths that write Z), and the mean and max abs error of sdf, grad and the
features. It runs on the card, and raises without one unless ``--device
cpu`` asks for the CPU, where every path is the plain version.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ..cli.eval import bench_mlp_config, union_codes_config
from ..device import resolve_device
from ..kernels.sdf_grad import gate100, pe_with_tangents, sdf_mlp_with_grad, sdf_mlp_with_grad_plain
from ..models.fields import effective_linear_weights
from ..models.monosdf import init_monosdf

CONFIGS = {"union": union_codes_config, "mlp": bench_mlp_config}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def reference64(ws, bs, x, multires: int, skip_in):
    """K2f's function at its bf16 rounding points with float64 sums: (sdf,
    feat, grad) float64 and the hidden layers' Z at bf16, (4, N, out_l)."""
    N = x.shape[0]
    emb, tang = pe_with_tangents(x.double(), multires)
    A0 = torch.cat([emb, tang], dim=0)
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


def measure(model: str = "union", n: int = 100_352, device=None, seed: int = 0) -> dict:
    dev = resolve_device(device)
    cfg = CONFIGS[model]("bfloat16")
    imp = cfg.implicit
    net = init_monosdf(cfg, seed=seed, device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    result = {"model": model, "points": n, "device": str(dev)}
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() > 0:
                p.add_(0.01 * torch.randn(p.shape, generator=gen).to(dev))
        ws, bs = effective_linear_weights(net.implicit)
        x = np.random.default_rng(seed).uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        args = (ws, bs, x, imp.multires, imp.skip_in, torch.bfloat16)
        ref = reference64(*args[:5])
        paths = {
            "train_kernel": sdf_mlp_with_grad(*args, save_z=True),
            "chunk_kernel": sdf_mlp_with_grad(*args),
            "plain": sdf_mlp_with_grad_plain(*args, save_z=True),
        }
        for name, out in paths.items():
            r = {}
            for what, i in (("sdf", 0), ("grad", 2), ("feat", 1)):
                e = (out[i].double() - ref[i]).abs()
                r[f"{what}_mean_abs_err"] = float(e.mean())
                r[f"{what}_max_abs_err"] = float(e.max())
            if len(out) == 5:
                r["z_off_share"] = [float((z != zr).float().mean()) for z, zr in zip(out[4], ref[3])]
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

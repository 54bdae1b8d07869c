"""Micro-timing of the error-bounded sampler's pieces around the SDF sweeps
on the card (the port of scripts/bench_sampler_machinery.py), on the
port's own functions (``monosdf_torch/ops/sampler.py``) at the JAX
script's sizes, R = 1024 rays:

    python -m monosdf_torch.scripts.bench_sampler_machinery [--rays 1024] [--iters 100] [--device cpu]

- ``torch.cumsum`` along the samples at N 256 and 640;
- ``_error_bound`` eleven times in a row (one beta bisection's bounds,
  each beta fed by the last bound) at N 128, 256, 384, 512 and 640;
- ``_merge_sorted_sort`` of N + 128 samples, N 128 to 512;
- ``_sample_pdf`` (inverse-CDF draws) at (N, M) (128, 128) to (640, 64);
- the final sort of 98 samples a ray.

Each is called once, then ``--iters`` times between two CUDA events (on
the CPU: the host clock). Prints one JSON line a measurement: ``op``,
``rays``, ``n`` (and ``m``), ``ms`` a call, ``device``. Inputs are seeded
numpy draws (``default_rng(0)``), as the JAX script's.

The JAX script's other rows are its lowering experiments, which compute
the same values by other means and have no implementation in the port:
cumsum as a triangular matmul (HIGHEST and DEFAULT precision), cumsum by
``associative_scan``, and the bitonic merge (``_merge_sorted_bitonic``,
``SamplerConfig.merge_impl``). K4's own per-launch times (the machinery
kernel that replaces ``_error_bound``'s bisection and the pdf) stay in
``monosdf_torch/scripts/kernel_ab.py``. The JAX script has no flags; the
port adds ``--rays``, ``--iters`` and ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sampler import _d_star, _error_bound, _merge_sorted_sort, _sample_pdf


def timer(device: torch.device, iters: int):
    """``ms(fn, *args)``: ms a call of fn over ``iters`` calls after one."""

    def ms(fn, *args) -> float:
        fn(*args)
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            return (time.perf_counter() - t0) * 1e3 / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters

    return ms


def _bisect11(sdf, z, dists, dstar):
    beta = torch.full((z.shape[0], 1), 0.05, dtype=z.dtype, device=z.device)
    e = _error_bound(beta, sdf, z, dists, dstar)
    for _ in range(10):
        beta = beta * 0.9 + 1e-30 * e[:, None]
        e = _error_bound(beta, sdf, z, dists, dstar)
    return e


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    R, ms = args.rays, timer(dev, args.iters)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    uniform = lambda lo, hi, *s: t(rng.uniform(lo, hi, s))
    sorted_z = lambda n: t(np.sort(rng.uniform(0, 3, (R, n)), -1))
    lines = []

    def emit(op, value, **shape):
        line = {"op": op, "rays": R, **shape, "ms": value, "device": name}
        print(json.dumps(line), flush=True)
        lines.append(line)

    for n in (256, 640):
        x = uniform(0, 1, R, n)
        emit("cumsum", ms(lambda a: torch.cumsum(a, dim=-1), x), n=n)
    for n in (128, 256, 384, 512, 640):
        z = sorted_z(n)
        sdf = t(rng.normal(0, 0.3, (R, n)))
        dists = z[:, 1:] - z[:, :-1]
        emit("error_bound x11", ms(_bisect11, sdf, z, dists, _d_star(z, sdf)), n=n)
    for n in (128, 256, 384, 512):
        z_old, s_old = sorted_z(n), t(rng.normal(0, 1, (R, n)))
        z_new, s_new = sorted_z(128), t(rng.normal(0, 1, (R, 128)))
        emit("merge sort", ms(_merge_sorted_sort, z_old, s_old, z_new, s_new), n=n, m=128)
    for n, m in ((128, 128), (256, 128), (384, 128), (512, 128), (640, 64)):
        bins, pdf, u = sorted_z(n), uniform(0, 1, R, n - 1), uniform(0, 1, R, m)
        emit("sample_pdf", ms(_sample_pdf, bins, pdf, u), n=n, m=m)
    zf = uniform(0, 3, R, 98)
    emit("final sort", ms(lambda a: torch.sort(a, dim=-1), zf), n=98)
    return lines


if __name__ == "__main__":
    main()

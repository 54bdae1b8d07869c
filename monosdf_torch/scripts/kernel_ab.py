"""Hash and time K4 (the sampler machinery), K6 (the hash encode) and K5
(its table gradient) on the inputs of chip_smoke.py, so that two
checkouts can be compared bit for bit and in turns in one run on one card:

    python monosdf_torch/scripts/kernel_ab.py [--root CHECKOUT] [--reps 20]

``--root`` imports ``monosdf_torch`` from another checkout (default: this
one); the inputs and the timers are this checkout's chip_smoke.py
(``k4_inputs``, ``grid_step_points``, ``cuda_ms``, ``device_ms``,
``host_us``). Prints one JSON line: per kernel and input set, a digest of
the outputs (sha256 of their bytes), the wall ms per call, the device ms
per call and the host us per call. The inputs:
- K4 at the 5 sampler iterations' shapes, beta0 = 0.01, 1e-3 and 1e-4
  (small betas reach exp's subnormal range), float32 and bf16;
- K6 and K5 on the hash-grid model's bf16 table (random values) at uniform
  random points of the scene box and at the points of one grid training
  step (its sweeps' and the differentiated encode's); K5's digest from
  single-point calls, so that no table row takes more than two atomic adds
  and the sums do not depend on their order; and at both point sets the
  atomics K5 issues (``k5_atomics``), which depend on the points alone.

``--probes`` times G (the dynamic gather), S (the run scatter), R (the
per-row bulk copy) and C (the capacity probe) instead (``--kernels``
picks some), at the smoke's probe cases (``PROBE_CASES``: inputs from the
checkout's own probe waves, seeded random values in place of the probe's
constant ones): a digest and whether a second call gives the same bits,
the error against the plain version over the smoke's bar, wall, device
(the kernel's, by the profiler; all of the call's device work with the
calls queued back to back, ``queued_ms``) and host time per call,
the library call's time, the bound, for R the copy floor, for G its
shared-memory floor and where it read the table; the probe's own ms per
launch of each case (``wave_ms``: its waves' timing, one warm-up call
then 5 timed calls) in a first and a second pass of the waves in one
process (``wave_ms_first_pass``); for G's staged axis-0 cases (this
checkout's column slices) the device ms at 0 and 1 reps, staged at the
case's width, beside the case's own (the staging and the index and
output traffic apart from the reps' reads); for C the device ms over its
ladder of sizes (one CTA: one SM's fill and store rate).
``--probes --sweep`` also times R over its ring depths, S's atomic
pass over its span lengths and G's staged axis-0 cases over the column
slice widths that fit (``stages``, ``span``, ``width``: keywords this
checkout's wrappers take) at the same inputs: wall, device and queued ms.
``--profiler_check N`` adds N readings of K5's device ms at the grid
step's points both ways: the sum over one profiler session (with its
recorded events and launches) and ``device_ms``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def k5_atomics(g, xs, size: float = 1.0) -> dict:
    """K5's atomic operations on the points xs of the grid g: the in-box
    points; the float2 atomics of one thread per (point, level), 8 a live
    pair; the kernel's (csrc/hash_encode_bwd.cu): per level, runs of
    neighbouring in-box points of one 32-point CTA in one base cell, whose
    first point adds each corner pair (c, c|1) with one float4 atomic where
    the two rows are an aligned pair, else two float2; and each level's
    share of live points that lead a run."""
    from monosdf_torch.ops.hashgrid import corner_geometry, level_rules

    L = g.num_levels
    idx, _, _, inb = corner_geometry(g, xs, size, L)
    live = inb > 0
    x01 = (xs + size) / (2.0 * size)
    first = torch.zeros_like(live)
    first[::32] = True
    ops = float4 = 0
    lead = []
    for l, rule in enumerate(level_rules(g)):
        res, fscale = float(rule[2]), float(rule[3])
        cell = torch.clamp(torch.floor(x01 * np.float32(fscale)), 0.0, res)
        same = torch.zeros_like(live)
        same[1:] = (cell[1:] == cell[:-1]).all(-1) & live[1:] & live[:-1]
        head = live & ~(same & ~first)
        r = idx[:, l]
        pair = torch.stack([(r[c] % 2 == 0) & (r[c + 1] == r[c] + 1) for c in (0, 2, 4, 6)]) & head
        ops += 8 * int(head.sum()) - int(pair.sum())
        float4 += int(pair.sum())
        lead.append(round(float(head.sum()) / max(1, int(live.sum())), 4))
    n = int(live.sum())
    return {"points": xs.shape[0], "points_in_box": n, "atomics_per_pair": 8 * n * L,
            "atomics": ops, "float4": float4, "run_leads_per_level": lead}


SWEEP = {"probe_row_copy": ("stages", (32, 64, 128, 256, 384)),
         "probe_scatter_rows": ("span", (8, 16, 32, 64, 128, 256)),
         "probe_gather": ("width", (1, 2, 4, 8, 16))}


def _sweep_values(cs, kernel: str, inputs: dict, where: str, dev) -> tuple:
    """The values of the kernel's swept keyword at these inputs: none for
    S's sorted pass and for G's cases that are not staged along axis 0; G's
    widths whose column slice fits one block's shared memory."""
    if kernel not in SWEEP or inputs.get("sorted_offs"):
        return ()
    values = SWEEP[kernel][1]
    if kernel == "probe_gather":
        from monosdf_torch.kernels import probes

        if inputs["axis"] != 0 or where != "shared":
            return ()
        tbl, optin = inputs["tbl"], probes.gather_limits(dev.index or 0)[0]
        values = tuple(v for v in values if tbl.shape[0] * v * tbl.element_size() <= optin)
    return values


def probes_ab(cs, dev, reps: int, sweep: bool = False, kernels=None) -> dict:
    """G, S, R and C (or ``kernels``) at the smoke's probe cases (see the
    module's docstring)."""
    from monosdf_torch.scripts import probe_hash_primitives as probe

    kernels = kernels or cs.SPLIT_KERNELS
    cases = {c: kw for c, (kw, _) in cs.PROBE_CASES.items() if kw in kernels}
    first_pass: dict = {}
    keep: dict = {}
    for kept in (first_pass, keep):  # the waves twice: a process's first timed calls apart
        for w in sorted({cs.PROBE_CASES[c][1] for c in cases}):
            probe.WAVES[w](dev, only=tuple(c for c in cases if cs.PROBE_CASES[c][1] == w),
                           keep=kept)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    fns, out = cs._probe_fns(), {}
    for case, kernel in cases.items():
        wrap, plain = fns[kernel]
        inputs = cs._random_like(kernel, keep[case]["inputs"], gen)
        fn = lambda: wrap(**inputs)
        where = []
        first, second = wrap(**inputs, **({"where": where} if kernel == "probe_gather" else {})), fn()
        err, ratio = cs._probe_err(kernel, inputs, first, plain(**inputs))
        entry = {"kernel": kernel, "digest": digest(first),
                 "rerun_bit_equal": cs.bits_equal(first, second), "max_abs_err": err,
                 "err_over_tolerance": ratio, "ms": cs.cuda_ms(fn, reps),
                 "device_ms": cs.device_ms(fn, kernel, reps), "queued_ms": cs.queued_ms(fn),
                 "host_us": cs.host_us(fn),
                 "library_ms": cs.cuda_ms(cs._probe_library(kernel, inputs), reps),
                 "bound_ms": cs._probe_bound(kernel, inputs, first)[0]}
        if kernel == "probe_row_copy":
            entry["copy_floor_ms"] = cs.row_copy_floor_ms(inputs)
        entry.update(wave_ms_first_pass=first_pass[case]["ms"], wave_ms=keep[case]["ms"])
        if kernel == "probe_gather":
            entry.update(where=where[0], smem_floor_ms=cs.smem_floor_ms(inputs))
            from monosdf_torch.kernels import probes

            if where[0] == "shared" and inputs["axis"] == 0 and hasattr(probes, "gather_plan"):
                tbl = inputs["tbl"]
                w = probes.gather_plan(tbl.shape[0], inputs["idx"].shape[0], 0, inputs["reps"],
                                       tbl.element_size(), probes.gather_limits(dev.index or 0))[1]
                at = lambda r: lambda: wrap(**{**inputs, "reps": r}, width=w)
                entry["device_ms_by_reps"] = {r: cs.device_ms(at(r), kernel, reps)
                                              for r in (0, 1)}
        if kernel == "probe_capacity":
            at = lambda kb: lambda: wrap(rows=kb * 2, device=inputs["device"])
            entry["device_ms_by_kb"] = {kb: cs.device_ms(at(kb), kernel, reps)
                                        for kb in (1, 32, 64, 128, 227)}
        values = _sweep_values(cs, kernel, inputs, where[0] if where else "", dev) if sweep else ()
        if values:
            key = SWEEP[kernel][0]
            at = lambda v: lambda: wrap(**inputs, **{key: v})
            entry["sweep"] = {v: (cs.cuda_ms(at(v), reps), cs.device_ms(at(v), kernel, reps),
                                  cs.queued_ms(at(v)))
                              for v in values}
        out[case] = entry
    return out


def profiler_check(cs, fn, kernel: str, n: int, reps: int) -> dict:
    """n readings of the kernel's device ms a call of fn both ways: the sum
    over one profiler session of ``reps`` calls (``_profile``), with its
    recorded events and launches, and ``device_ms`` (the mean of the
    recorded events' durations times the launches a call)."""
    sums = [cs._profile(fn, reps, kernel) for _ in range(n)]
    return {"session_sums": [(round(p["kernels_ms"][kernel], 5), p["kernel_events"].get(kernel, 0),
                              p["launches"].get(kernel, 0)) for p in sums],
            "device_ms": [round(cs.device_ms(fn, kernel, reps), 5) for _ in range(n)]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probes", action="store_true", help="time the probe kernels G, S, R, C only")
    ap.add_argument("--kernels", default="",
                    help="with --probes: a comma list of them (probe_gather, ...)")
    ap.add_argument("--sweep", action="store_true",
                    help="with --probes: R's rings, S's spans, G's slice widths")
    ap.add_argument("--profiler_check", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    root = os.path.abspath(args.root or HERE)
    sys.path.insert(0, root)
    from monosdf_torch.cli.eval import bench_grids_config, bench_mlp_config
    from monosdf_torch.kernels import hash_encode as k6
    from monosdf_torch.kernels import sampler_machinery as k4

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    if args.probes:
        out["probes"] = probes_ab(cs, dev, args.reps, args.sweep,
                                  tuple(k for k in args.kernels.split(",") if k))
        print(json.dumps(out))
        return
    timing = lambda fn, kernel: {"ms": cs.cuda_ms(fn, args.reps),
                                 "device_ms": cs.device_ms(fn, kernel, args.reps),
                                 "host_us": cs.host_us(fn)}

    # K4
    sc = bench_mlp_config("bfloat16").sampler
    rows = cs.k4_inputs(np.random.default_rng(0), dev, sc.max_total_iters, sc.N_samples_eval)
    k4_out = {}
    for b0 in (1e-2, 1e-3, 1e-4):
        for dname, d in (("float32", None), ("bfloat16", torch.bfloat16)):
            outs = [o for st, dt, ds, bp, _, last in rows
                    for o in k4.sampler_iter_machinery(st, dt, ds, bp, torch.tensor(b0, device=dev),
                                                       0.1, 1e-6, last, 10, d)]
            k4_out[f"beta0={b0} {dname}"] = digest(*outs)
    calls = [lambda r=r: k4.sampler_iter_machinery(*r[:5], 0.1, 1e-6, r[5], 10, torch.bfloat16)
             for r in rows]
    per = [timing(c, "sampler_machinery") for c in calls]
    for key in ("ms", "device_ms"):
        k4_out[f"{key}_per_shape"] = [p[key] for p in per]
        k4_out[key] = sum(k4_out[f"{key}_per_shape"]) / len(per)
    k4_out["host_us"] = per[0]["host_us"]
    out["sampler_machinery"] = k4_out

    # K6 and K5
    gcfg = bench_grids_config("bfloat16")
    g, df = gcfg.implicit.grid, gcfg.implicit.divide_factor
    gen = torch.Generator().manual_seed(0)
    tab = ((torch.rand(g.table_size * 2, generator=gen) * 2 - 1) * 1e-2).to(dev).to(torch.bfloat16)
    sweeps, xo = cs.grid_step_points(gcfg, dev)
    rng = np.random.default_rng(4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    N, K = xo.shape[0], gcfg.sweep_max_level
    sets = {"random": ([(t(rng.uniform(-1.12, 1.12, sweeps[0][0].shape)) / df, K)],
                       t(rng.uniform(-1.12, 1.12, (N, 3))) / df),
            "step": (sweeps, xo)}
    out["step_points"] = digest(xo, *(x for x, _ in sweeps))
    cf, ct = t(rng.normal(size=(N, 32))), t(rng.normal(size=(3, N, 32)))
    for tag, (sw, xs) in sets.items():
        step = lambda: k6.hash_encode_fwd(tab, g, xs, 1.0, None, True, 1.0 / df)
        sweep = [lambda x=x, k=k: k6.hash_encode_fwd(tab, g, x, 1.0, k) for x, k in sw]
        bwd = lambda: k6.hash_encode_bwd(g, xs, cf, ct, 1.0, 1.0 / df)
        one = [k6.hash_encode_bwd(g, xs[i:i + 1].contiguous(), cf[i:i + 1].contiguous(),
                                  ct[:, i:i + 1].contiguous(), 1.0, 1.0 / df)
               for i in range(0, N, N // 32)]
        out.setdefault("hash_encode", {})[tag] = {"digest": digest(*step()),
                                                  **timing(step, "hash_encode")}
        per = [timing(f, "hash_encode") for f in sweep]
        out.setdefault("hash_encode_sweep", {})[tag] = {
            "digest": digest(*(f() for f in sweep)),
            **{k: sum(p[k] for p in per) / len(per) for k in per[0]}}
        out.setdefault("hash_encode_bwd", {})[tag] = {
            "digest": digest(*(v for d in one for v in (d.nonzero().flatten(), d[d != 0]))),
            **timing(bwd, "hash_encode_bwd"), "atomics": k5_atomics(g, xs)}
        if args.profiler_check and tag == "step":
            out["hash_encode_bwd"][tag]["profiler_check"] = profiler_check(
                cs, bwd, "hash_encode_bwd", args.profiler_check, 10)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

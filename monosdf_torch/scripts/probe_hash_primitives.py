"""Microbenchmarks of the hash-grid encoder's primitives on the card.

    python -m monosdf_torch.scripts.probe_hash_primitives            # all eight waves
    python -m monosdf_torch.scripts.probe_hash_primitives --wave 4   # one wave (or --wave4)
    python -m monosdf_torch.scripts.probe_hash_primitives --wave 1 --only pl_gather,sort

The port of ``scripts/probe_hash_primitives.py``: the same eight waves of
gathers, scatters, sorts, bulk copies and on-chip capacity checks at the
hash-grid model's sizes (``T`` table rows, ``N_GATHER`` sweep corner
lookups, ``N_SCATTER`` corner updates, ``N_FOLD`` fold rows), measured on
the card so that the K5/K6/K7b designs start from its rates. What the JAX
script left to XLA runs as PyTorch library calls; its eight Pallas kernels
run as the five hand-written kernels of ``kernels/probes.py`` (G, S, R, M,
C). Each wave prints ``name ms detail`` lines and ends with one JSON dict
of the times (ms; null where a probe was refused or has no counterpart).
``--only`` keeps the probes whose group or name it lists.

Timing: warm-up calls, then CUDA events around the timed calls; a time is
per call divided by the iterations the call chains (the take loops chain
``ITERS``, the G probes run ``reps`` gathers in one launch). Indices and
values come from a ``torch.Generator`` seeded 0 in every wave. A kernel
that fails raises; only C's refusal at the TPU's VMEM sizes is a result.

It runs on the card and raises without one unless ``--device cpu`` (or
``device="cpu"`` to a wave function) asks for the CPU, where the kernels'
plain versions run and the times are the CPU's. Every wave function takes
its sizes as keywords that default to the script's; the tests call them
with tiny ones.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..device import resolve_device
from ..kernels import build, probes

T = 6_098_108          # flagship table entries
N_GATHER = 16_777_216  # sweep corner-lookups (131072 pts x 8 x 16)
N_SCATTER = 12_845_056  # diff-path corner-updates (100352 pts x 8 x 16)
N_FOLD = 1_605_632     # fold-scatter rows: 100,352 diff points x 16 levels
ITERS = 3              # iterations the take loops chain in one call
KERNEL_CALLS = 5       # timed calls of a kernel case, after one warm-up call
LAUNCHES_PER_CASE = 1 + KERNEL_CALLS  # wrapper calls (launch counts) per kernel case


class Probe:
    """One wave's device, generator (seeded 0), results and filter; with
    ``keep`` (a dict) every kernel case stores there its inputs, last
    output and ms per launch."""

    def __init__(self, wave: int, device=None, only=(), keep: dict | None = None, width: int = 44):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.only = set(only)
        self.keep = keep
        self.width = width
        self.results: dict = {}
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self._streams: list = []
        self.last_out = None
        where = torch.cuda.get_device_name(self.device) if self.cuda else "cpu (plain versions)"
        print(f"# wave {wave} on {where}", flush=True)

    def want(self, *names) -> bool:
        return not self.only or any(n in self.only for n in names)

    def report(self, name: str, ms, detail: str = ""):
        self.results[name] = None if ms is None else round(ms, 3)
        shown = f"{'-':>10s}" if ms is None else f"{ms:10.3f}"
        print(f"{name:{self.width}s} {shown} ms  {detail}", flush=True)

    def done(self) -> dict:
        print(json.dumps(self.results), flush=True)
        return self.results

    # -- data, from the wave's generator ----------------------------------

    def randint(self, lo: int, hi: int, shape):
        return torch.randint(lo, hi, tuple(shape), generator=self.gen, device=self.device,
                             dtype=torch.int32)

    def randn(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def full(self, shape, value: float, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype, device=self.device)

    # -- timing -------------------------------------------------------------

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def timed(self, fn, *args, iters: int = 1, warmup: int = 1, calls: int = 1) -> float:
        """ms per iteration: ``warmup`` calls, then CUDA events (the CPU's
        clock on the CPU) around ``calls`` calls of fn, each chaining
        ``iters`` iterations."""
        for _ in range(warmup):
            fn(*args)
        self.sync()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn(*args)
            end.record()
            torch.cuda.synchronize(self.device)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
        return ms / calls / iters

    def kernel_case(self, name: str, fn, inputs: dict, per: tuple | None = None, **extra):
        """(ms per rep, rate) of fn(**inputs, **extra): one warm-up call, then
        ``KERNEL_CALLS`` timed calls, each launch's time over its
        ``inputs["reps"]`` (1 when absent); the rate is ns per rep and
        ``per = (count, unit)`` item (None without ``per``). The warm-up
        call's output in ``last_out``; in ``keep`` when given, the inputs,
        that output, ms per launch and per rep, the rate and its unit."""
        out = self.last_out = fn(**inputs, **extra)
        ms = self.timed(lambda: fn(**inputs, **extra), warmup=0, calls=KERNEL_CALLS)
        ms_rep = ms / inputs.get("reps", 1)
        rate = None if per is None else ms_rep * 1e6 / per[0]
        if self.keep is not None:
            self.keep[name] = {"inputs": inputs, "out": out, "ms": ms, "ms_per_rep": ms_rep,
                               "rate": rate, "rate_unit": None if per is None else per[1]}
        return ms_rep, rate

    def on_streams(self, fns) -> list:
        """Each fn on its own CUDA stream, as independent ops that the card
        may overlap; the results ready on the current stream. In order on
        the CPU."""
        if not self.cuda:
            return [f() for f in fns]
        while len(self._streams) < len(fns):
            self._streams.append(torch.cuda.Stream(self.device))
        cur = torch.cuda.current_stream(self.device)
        outs = []
        for s, f in zip(self._streams, fns):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                outs.append(f())
        for s, o in zip(self._streams, outs):
            cur.wait_stream(s)
            o.record_stream(cur)
        return outs


def take_loop(emb, idx, iters: int = ITERS):
    """``iters`` takes of emb's rows at idx + i (clipped), each summed in
    float32."""
    acc = torch.zeros((), dtype=torch.float32, device=emb.device)
    hi = emb.shape[0] - 1
    for i in range(iters):
        acc = acc + emb.index_select(0, (idx + i).clamp_(max=hi)).float().sum()
    return acc


def scatter_sum(rows: int, width: int, idx, vals, dtype=torch.float32):
    """zeros (rows, width) (or (rows,) for width 0) with vals added at idx,
    summed in float32."""
    shape = (rows,) if width == 0 else (rows, width)
    z = torch.zeros(shape, dtype=dtype, device=vals.device)
    return z.index_add_(0, idx, vals).float().sum()


def sort_carry(keys, *vals, dim: int = -1):
    """Keys sorted along ``dim``, each value array carried by the
    permutation."""
    k, perm = torch.sort(keys, dim=dim)
    return (k, *(torch.gather(v, dim, perm) for v in vals))


def _name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


# ---------------------------------------------------------------------------
# wave 1: XLA gather / scatter, sort, cumsum; G (P1) and S (P2)


def wave1(device=None, only=(), keep=None, *, T=T, N_GATHER=N_GATHER, N_SCATTER=N_SCATTER,
          dg_rows=(8, 512, 4096, 8192), dg_ax1_rows=512, reps=32, store_runs=512,
          store_rows=4096):
    p = Probe(1, device, only, keep, width=36)

    if p.want("xla_take"):
        for dt in (torch.float32, torch.bfloat16):
            emb = p.full((T, 2), 0.5, dt)
            idx = p.randint(0, T, (N_GATHER,))
            ms = p.timed(take_loop, emb, idx, iters=ITERS)
            p.report(f"xla_take_{_name(dt)}", ms, f"{N_GATHER} rows")
            del emb, idx

    if p.want("xla_scatter"):
        vals = p.full((N_SCATTER, 2), 1.0)
        idx_rand = p.randint(0, T, (N_SCATTER,))
        idx_sorted = torch.sort(idx_rand)[0]
        idx_unique = torch.arange(N_SCATTER, dtype=torch.int32, device=p.device) % T
        for tag, idx in (("random", idx_rand), ("sorted", idx_sorted),
                         ("sorted_unique", torch.sort(idx_unique)[0])):
            # index_add_ takes no sortedness or uniqueness hint: the indices are
            # what differs
            p.report(f"xla_scatter_{tag}", p.timed(scatter_sum, T, 2, idx, vals))
        del vals, idx_rand, idx_sorted, idx_unique

    if p.want("sort"):
        keys = p.randint(0, T, (N_SCATTER,))
        v0 = p.full((N_SCATTER,), 1.0)
        v1 = p.full((N_SCATTER,), 1.0)

        def sort1(keys, v0):
            k, a = sort_carry(keys, v0)
            return k[-1].float() + a[0]

        def sort2(keys, v0, v1):
            k, a, b = sort_carry(keys, v0, v1)
            return k[-1].float() + a[0] + b[0]

        p.report("sort_key_1val_12.8M", p.timed(sort1, keys, v0))
        p.report("sort_key_2val_12.8M", p.timed(sort2, keys, v0, v1))
        p.report("cumsum_12.8M", p.timed(lambda v: torch.cumsum(v, 0)[-1], v0))
        del keys, v0, v1

    def probe_dg(rows, axis):
        name = f"pl_dyngather_ax{axis}_{rows}x128"
        if not p.want("pl_gather", name):
            return
        tbl = p.randn(rows, 128)
        idx = p.randint(0, rows if axis == 0 else 128, (rows, 128))
        where = []
        ms, rate = p.kernel_case(name, probes.gather, dict(tbl=tbl, idx=idx, axis=axis, reps=reps),
                                 per=(rows * 128, "ns/elem"), where=where)
        read = f"table in {where[0]}" if where else "plain version"
        p.report(name, ms, f"{rate:.3f} ns/elem ({reps} reps in kernel; {read})")

    for rows in dg_rows:
        probe_dg(rows, 0)
    probe_dg(dg_ax1_rows, 1)

    if p.want("pl_store", "pl_dynslice_store_512x8rows"):
        offs = torch.sort(p.randint(0, store_rows - 8, (store_runs,)))[0]
        vals = p.full((8 * store_runs, 128), 1.0)
        ms, rate = p.kernel_case("pl_dynslice_store_512x8rows", probes.scatter_rows,
                                 dict(offs=offs, vals=vals, rows=store_rows, run=8,
                                      sorted_offs=True),
                                 per=(store_runs, "ns/run"))
        p.report("pl_dynslice_store_512x8rows", ms, f"{rate:.1f} ns/run")

    return p.done()


# ---------------------------------------------------------------------------
# wave 2: coherence, row shape and table size


def wave2(device=None, only=(), keep=None, *, T=T, N_GATHER=N_GATHER, N_SCATTER=N_SCATTER,
          small_rows=4096, mid_rows=524_288, sort_rows=128, sort_cols=100_352):
    p = Probe(2, device, only, keep, width=40)

    if p.want("take"):
        emb = p.full((T, 2), 0.5)
        idx_rand = p.randint(0, T, (N_GATHER,))
        p.report("take_f32_random", p.timed(take_loop, emb, idx_rand, iters=ITERS))
        p.report("take_f32_sorted", p.timed(take_loop, emb, torch.sort(idx_rand)[0], iters=ITERS))
        # ray-coherent: rays of 128 consecutive-ish cells each
        base = p.randint(0, T - 512, (N_GATHER // 128, 1))
        walk = torch.cumsum(p.randint(0, 4, (N_GATHER // 128, 128)), dim=1, dtype=torch.int32)
        p.report("take_f32_raywalk", p.timed(take_loop, emb, (base + walk).reshape(-1),
                                             iters=ITERS))
        del base, walk
        for rows, tag in ((small_rows, "smalltable4k"), (mid_rows, "midtable512k")):
            tab = p.full((rows, 2), 0.5)
            p.report(f"take_f32_{tag}", p.timed(take_loop, tab, p.randint(0, rows, (N_GATHER,)),
                                                iters=ITERS))
        # flat scalar-row gather
        idx_flat = p.randint(0, 2 * T, (N_GATHER,))
        p.report("take_f32_flat1d", p.timed(take_loop, p.full((2 * T,), 0.5), idx_flat,
                                            iters=ITERS))
        idx_half = p.randint(0, T // 2, (N_GATHER // 2,))
        pairs = emb.reshape(T // 2, 4)
        p.report("take_f32_pairrows_half", p.timed(take_loop, pairs, idx_half, iters=ITERS),
                 f"{N_GATHER // 2} rows of 4ch")
        p.report("take_bf16_pairrows_half", p.timed(take_loop, pairs.bfloat16(), idx_half,
                                                    iters=ITERS))
        quads = emb.bfloat16().reshape(T // 4, 8)
        idx_q = p.randint(0, T // 4, (N_GATHER // 4,))
        p.report("take_bf16_quadrows_quarter", p.timed(take_loop, quads, idx_q, iters=ITERS),
                 f"{N_GATHER // 4} rows of 8ch bf16")
        del emb, idx_rand, pairs, quads, idx_half, idx_q
    else:
        idx_flat = None

    if p.want("scatter"):
        vals2 = p.full((N_SCATTER, 2), 1.0)
        idxs = p.randint(0, T, (N_SCATTER,))
        p.report("scatter2ch_random", p.timed(scatter_sum, T, 2, idxs, vals2))
        if idx_flat is None:
            idx_flat = p.randint(0, 2 * T, (N_GATHER,))
        p.report("scatter_flat_scalar", p.timed(scatter_sum, 2 * T, 0, idx_flat[:N_SCATTER],
                                                p.full((N_SCATTER,), 1.0)),
                 f"{N_SCATTER} scalar rows")
        p.report("scatter_small4k", p.timed(scatter_sum, small_rows, 2,
                                            p.randint(0, small_rows, (N_SCATTER,)), vals2))
        # wide rows: an eighth as many rows of 16 channels
        p.report("scatter_16ch_eighth", p.timed(scatter_sum, T // 8, 16,
                                                p.randint(0, T // 8, (N_SCATTER // 8,)),
                                                p.full((N_SCATTER // 8, 16), 1.0)),
                 f"{N_SCATTER // 8} rows of 16ch")
        del vals2, idxs
    del idx_flat

    if p.want("sort2d"):
        # row-parallel 2D sort: (sort_rows, sort_cols) keys + payload
        k2d = p.randint(0, mid_rows, (sort_rows, sort_cols))
        v2d = p.full((sort_rows, sort_cols), 1.0)

        def sort2d(k, v):
            ks, vs = sort_carry(k, v, dim=1)
            return ks[0, -1].float() + vs[0, 0]

        p.report("sort2d_128x100k_1val", p.timed(sort2d, k2d, v2d))
        p.report("cumsum2d_128x100k", p.timed(lambda v: torch.cumsum(v, 1)[0, -1], v2d))

    return p.done()


# ---------------------------------------------------------------------------
# wave 3: scatter encodings (complex64 channel packing, bf16 rows, batched
# per level) and matching gather forms


def wave3(device=None, only=(), keep=None, *, T=T, N_GATHER=N_GATHER, N_SCATTER=N_SCATTER,
          level_rows=524_288):
    p = Probe(3, device, only, keep, width=40)
    idx = p.randint(0, T, (N_SCATTER,))

    if p.want("scatter"):
        # complex64: both channels ride one scalar row (view_as_complex)
        vr = p.full((N_SCATTER,), 1.0)

        def sc_c64(idx, v):
            vc = torch.view_as_complex(torch.stack([v, v * 2.0], -1))
            acc = torch.zeros(T, dtype=torch.complex64, device=v.device).index_add_(0, idx, vc)
            return acc.real.sum() + acc.imag.sum()

        try:
            p.report("scatter_c64_flat", p.timed(sc_c64, idx, vr))
        except RuntimeError as e:
            p.report("scatter_c64_flat", None, f"FAILED {type(e).__name__}: {str(e)[:120]}")
        # bf16 (T, 2) rows = 4-byte rows
        p.report("scatter_bf16_2ch", p.timed(scatter_sum, T, 2, idx,
                                             p.full((N_SCATTER, 2), 1.0, torch.bfloat16),
                                             torch.bfloat16))
        # batched per-level scatter (16 rows of updates into level_rows each)
        idx2 = p.randint(0, level_rows, (16, N_SCATTER // 16))
        v2 = p.full((16, N_SCATTER // 16), 1.0)

        def sc_batched(idx, v):
            z = torch.zeros(16, level_rows, dtype=torch.float32, device=v.device)
            return z.scatter_add_(1, idx.long(), v).sum()

        p.report("scatter_f32_batched16", p.timed(sc_batched, idx2, v2))
        del vr, idx2, v2

    if p.want("take"):
        # gather complex64 flat (8-byte scalar rows)
        embr = p.full((T,), 0.5)
        idxg = p.randint(0, T, (N_GATHER,))

        def take_c64(embr, i):
            emb = torch.view_as_complex(torch.stack([embr, embr], -1))
            acc = torch.zeros((), dtype=torch.float32, device=embr.device)
            for k in range(ITERS):
                v = emb.index_select(0, (i + k).clamp_(max=T - 1))
                acc = acc + v.real.sum() + v.imag.sum()
            return acc

        try:
            p.report("take_c64_flat", p.timed(take_c64, embr, idxg, iters=ITERS))
        except RuntimeError as e:
            p.report("take_c64_flat", None, f"FAILED {type(e).__name__}: {str(e)[:120]}")
        # gather bf16 16ch rows (32 B)
        emb16 = p.full((T // 8, 16), 0.5, torch.bfloat16)
        idx16 = p.randint(0, T // 8, (N_GATHER // 8,))
        p.report("take_bf16_16ch_2.1M", p.timed(take_loop, emb16, idx16, iters=ITERS),
                 f"{N_GATHER // 8} rows of 32B")

    return p.done()


# ---------------------------------------------------------------------------
# wave 4: the corner-affine fold scatter designs; C (P3) and S (P4)


def capacity_probes(p: Probe, vmem_mb, smem_kb):
    """The TPU's VMEM requests (refused on the card: one block's shared
    memory is the counterpart) and the card's own ladder, each a whole
    (rows, 128) float32 output in one CTA's shared memory (C)."""
    if p.cuda:
        lim = probes.device_limits(p.device)
        print(f"on-chip capacities (bytes): {json.dumps(lim)}", flush=True)
    else:
        print("on-chip capacities: not measured (cpu)", flush=True)
    cases = [(f"vmem_alloc_{mb}MB", mb * 1024 * 1024, True) for mb in vmem_mb]
    cases += [(f"smem_alloc_{kb}KB", kb * 1024, False) for kb in smem_kb]
    for name, nbytes, tpu_size in cases:
        if not p.want("vmem_alloc" if tpu_size else "smem_alloc", name):
            continue
        rows = nbytes // (128 * 4)
        try:
            ms, _ = p.kernel_case(name, probes.capacity, dict(rows=rows, device=p.device))
        except probes.Refused as e:
            if not tpu_size:
                raise  # the card's own ladder must launch
            p.report(name, None, f"FAILED (refused at {e.where}): {e}")
            continue
        out = p.last_out
        if not torch.equal(out, probes.capacity_plain(rows, p.device)):
            raise RuntimeError(f"{name}: the capacity kernel's output is wrong")
        p.report(name, ms, f"ok v={float(out[0, 0])}, {nbytes} bytes in one CTA's shared memory")


RMW_CASES = (  # (updates, accumulator rows, chunk, value dtype, tag, all indices 0)
    (100_352, 4096, 1024, torch.bfloat16, "100k_4krows_bf16", False),
    (100_352, 65536, 1024, torch.bfloat16, "100k_64krows_bf16", False),
    (100_352, 65536, 1024, torch.float32, "100k_64krows_f32", False),
    (802_816, 65536, 2048, torch.bfloat16, "800k_64krows_bf16", False),
    (100_352, 65536, 1024, torch.bfloat16, "100k_conflict", True),
)


def wave4(device=None, only=(), keep=None, *, T=T, N_FOLD=N_FOLD, vmem_mb=(32, 64, 96, 110),
          smem_kb=(32, 64, 128, 227), rmw=RMW_CASES, sort_cols=100_352, sort_keys=524_288):
    p = Probe(4, device, only, keep)

    # ---- XLA wide-row scatters (full fold table: T rows of 16ch) ------------
    if p.want("xla_scatter"):
        for width, dt in ((16, torch.float32), (16, torch.bfloat16), (128, torch.float32)):
            name = f"xla_scatter_{width}ch_{_name(dt)}"
            idx = p.randint(0, T, (N_FOLD,))
            vals = p.full((N_FOLD, width), 1.0, dt)
            try:
                ms = p.timed(scatter_sum, T, width, idx, vals, dt)
                p.report(name, ms, f"{ms * 1e6 / N_FOLD:.1f} ns/row, {N_FOLD} rows")
            except RuntimeError as e:
                p.report(name, None, f"FAILED {type(e).__name__}: {str(e)[:120]}")
            del idx, vals

    # ---- on-chip capacity ----------------------------------------------------
    capacity_probes(p, vmem_mb, smem_kb)

    # ---- RMW scatter: accumulator (rows, 128) float32, one row per update ---
    for n_upd, acc_rows, chunk, dt, tag, conflict in rmw:
        name = f"pl_rmw_{tag}"
        if not p.want("pl_rmw", name):
            continue
        n_upd = (n_upd // chunk) * chunk
        if conflict:
            idx = torch.zeros(n_upd, dtype=torch.int32, device=p.device)
        else:
            idx = p.randint(0, acc_rows, (n_upd,))
        vals = p.full((n_upd, 128), 1.0, dt)
        ms, rate = p.kernel_case(name, probes.scatter_rows,
                                 dict(offs=idx, vals=vals, rows=acc_rows, run=1),
                                 per=(n_upd, "ns/update"))
        # the TPU streamed the updates in chunks; the card takes them all at once
        p.report(name, ms, f"{rate:.1f} ns/update, {n_upd} upd -> {acc_rows}x128 "
                           f"(TPU chunk {chunk})")

    # ---- 2D row-parallel sort/cumsum (16 levels as rows) --------------------
    if p.want("sort2d"):
        k2d = p.randint(0, sort_keys, (16, sort_cols))
        v2d = p.full((16, sort_cols), 1.0)

        def sort2d(k, v):
            ks, vs = sort_carry(k, v, dim=1)
            return ks[0, -1].float() + vs[0, 0]

        p.report("sort2d_16x100k_1val", p.timed(sort2d, k2d, v2d))
        p.report("cumsum2d_16x100k", p.timed(lambda v: torch.cumsum(v, 1)[0, -1], v2d))

    return p.done()


# ---------------------------------------------------------------------------
# wave 5: oct-layout gather rates + production-shape packed scatter


def wave5(device=None, only=(), keep=None, *, T=T, N_FOLD=N_FOLD, oct_rows=2_097_152,
          quad_rows=4_194_304, t8=762_264):
    p = Probe(5, device, only, keep)

    if p.want("take"):
        # oct layout: 1 gather of (16ch bf16 = 32B) per level-point
        emb16 = p.full((T, 16), 0.5, torch.bfloat16)
        for n, tag in ((oct_rows, "sweep131k"), (N_FOLD, "diff100k")):
            ms = p.timed(take_loop, emb16, p.randint(0, T, (n,)), iters=ITERS)
            p.report(f"take_oct_bf16_16ch_{tag}", ms, f"{ms * 1e6 / n:.2f} ns/row, {n} rows")
        del emb16
        # quad layout reference: 2 gathers of (8ch bf16 = 16B) per level-point
        emb8 = p.full((T, 8), 0.5, torch.bfloat16)
        ms = p.timed(take_loop, emb8, p.randint(0, T, (quad_rows,)), iters=ITERS)
        p.report("take_quad_bf16_8ch_4.2M", ms, f"{ms * 1e6 / quad_rows:.2f} ns/row")
        del emb8

    if p.want("scatter"):
        # production-shape packed fold scatter: (N_FOLD, 128) f32 -> (t8, 128)
        idx = p.randint(0, t8, (N_FOLD,))
        vals = p.full((N_FOLD, 128), 1.0)
        ms = p.timed(scatter_sum, t8, 128, idx, vals)
        p.report("xla_scatter_packed_prod", ms, f"{ms * 1e6 / N_FOLD:.1f} ns/row")

    return p.done()


# ---------------------------------------------------------------------------
# wave 6: ray-coherent gathers; the diff path's table-gradient scatter


def coherent_idx(p: Probe, n_rows: int, tmax: int):
    """Rays of 128 samples each, walking 0..3 cells from a random base."""
    rays = n_rows // 128
    base = p.randint(0, tmax - 512, (rays, 1))
    walk = torch.cumsum(p.randint(0, 4, (rays, 128)), dim=1, dtype=torch.int32)
    return (base + walk).reshape(-1)


def wave6(device=None, only=(), keep=None, *, T=T, oct_rows=2_097_152, quad_rows=4_194_304,
          fold_points=100_352):
    from ..kernels.hash_encode import hash_encode_bwd
    from ..ops.hashgrid import HashGridConfig

    p = Probe(6, device, only, keep)

    if p.want("take"):
        emb16 = p.full((T, 16), 0.5, torch.bfloat16)
        ms = p.timed(take_loop, emb16, coherent_idx(p, oct_rows, T), iters=ITERS)
        p.report("take_oct_16ch_coherent_2.1M", ms, f"{ms * 1e6 / oct_rows:.2f} ns/row")
        del emb16
        emb8 = p.full((T, 8), 0.5, torch.bfloat16)
        ms = p.timed(take_loop, emb8, coherent_idx(p, quad_rows, T), iters=ITERS)
        p.report("take_quad_8ch_coherent_4.2M", ms, f"{ms * 1e6 / quad_rows:.2f} ns/row")
        del emb8

    if p.want("fold"):
        # the diff path's table gradient at L = 16 levels x B points: the TPU
        # folded packed 8-corner rows at random base rows; the port's K5 adds
        # every corner's cotangent to its table row (points uniform in the
        # encoder's box [-1, 1]^3, feature cotangents of 1, no tangents)
        cfg = HashGridConfig(num_levels=16, level_dim=2, base_resolution=16,
                             log2_hashmap_size=19, desired_resolution=2048,
                             table_dtype="bfloat16", scatter_impl="fold", hash_scheme="add",
                             layout="oct")
        x = p.rand(fold_points, 3) * 2.0 - 1.0
        c_feat = p.full((fold_points, 2 * cfg.num_levels), 1.0)
        ms = p.timed(lambda: hash_encode_bwd(cfg, x, c_feat).sum())
        p.report("fold_transpose_prod", ms, f"{cfg.num_levels * fold_points} update rows "
                                            "(the port's K5, hash_encode_bwd)")
        p.report("build_oct_table", None, "no counterpart: the port's K6 reads the 8 corners "
                                          "directly and builds no oct table")

    return p.done()


# ---------------------------------------------------------------------------
# wave 7: latency-hiding groundwork; C (P5), R (P6) and M (P7)


def wave7(device=None, only=(), keep=None, *, T=T, N_FOLD=N_FOLD, N_Q=4_194_304,
          level_rows=524_288, mm_size=2048, mm_iters=128, t8=762_264,
          vmem_mb=(32, 64, 96, 110), smem_kb=(32, 64, 128, 227), dma_rows=65_536,
          permute_rows=8200, permute_out=1024):
    p = Probe(7, device, only, keep)

    # ---- (a) gather concurrency: K independent takes on K streams ----------
    emb8 = idx = None
    if p.want("take", "ovl"):
        emb8 = p.full((T, 8), 0.5, torch.bfloat16)
        idx = p.randint(0, T, (N_Q,))

    def take_sum(emb, i):
        return emb.index_select(0, i).float().sum()

    if p.want("take"):
        for K in (1, 2, 4, 8):
            chunks = [idx[i * (N_Q // K):(i + 1) * (N_Q // K)] for i in range(K)]
            ms = p.timed(lambda: sum(p.on_streams([lambda c=c: take_sum(emb8, c)
                                                   for c in chunks])))
            p.report(f"take_split{K}", ms, f"{K} independent takes on {K} streams, {N_Q} rows "
                                           "total")
        # per-level: 16 takes from 16 separate tables
        tabs = [p.full((level_rows, 8), 0.5, torch.bfloat16) for _ in range(16)]
        gens = [torch.Generator(device=p.device).manual_seed(i) for i in range(16)]
        idxs16 = [torch.randint(0, level_rows, (N_Q // 16,), generator=g, device=p.device,
                                dtype=torch.int32) for g in gens]
        ms = p.timed(lambda: sum(p.on_streams([lambda t=t, c=c: take_sum(t, c)
                                               for t, c in zip(tabs, idxs16)])))
        p.report("take_perlevel16", ms, f"16 tables x {N_Q // 16} rows, 16 streams")
        # batched single-op variant
        tabs_s, idxs_s = torch.stack(tabs), torch.stack(idxs16).long()
        lv = torch.arange(16, device=p.device)[:, None]
        ms = p.timed(lambda: tabs_s[lv, idxs_s].float().sum())
        p.report("take_batched16", ms, "one batched gather")
        del tabs, idxs16, tabs_s, idxs_s

    # ---- (b) gather + matmul overlap -----------------------------------------
    if p.want("ovl"):
        a = p.full((mm_size, mm_size), 0.01, torch.bfloat16)
        b = p.full((mm_size, mm_size), 0.01, torch.bfloat16)

        def mm():
            x = a
            for _ in range(mm_iters):
                x = torch.tanh(x @ b)
            return x.float().sum()

        ms_g = p.timed(take_sum, emb8, idx)
        p.report("ovl_gather_alone", ms_g)
        ms_m = p.timed(mm)
        p.report("ovl_matmul_alone", ms_m)
        ms_b = p.timed(lambda: sum(p.on_streams([lambda: take_sum(emb8, idx), mm])))
        p.report("ovl_both", ms_b, f"serial would be {ms_g + ms_m:.1f}; two streams")
    del emb8, idx

    # ---- (c) scatter concurrency: K independent packed scatters --------------
    if p.want("scatter"):
        vals = p.full((N_FOLD, 128), 1.0)
        idxf = p.randint(0, t8, (N_FOLD,))
        for K in (1, 2, 4):
            rows_k, n = t8 // K, N_FOLD // K
            cs = [idxf[i * n:(i + 1) * n] % rows_k for i in range(K)]
            vs = [vals[i * n:(i + 1) * n] for i in range(K)]
            ms = p.timed(lambda: sum(p.on_streams([lambda c=c, v=v: scatter_sum(rows_k, 128, c, v)
                                                   for c, v in zip(cs, vs)])))
            p.report(f"scatter_split{K}", ms, f"{K} scatters on {K} streams, {N_FOLD} rows total")
        del vals, idxf

    # ---- (d) on-chip capacity -------------------------------------------------
    capacity_probes(p, vmem_mb, smem_kb)

    # ---- (e) per-row bulk-copy gather (R) --------------------------------------
    if p.want("perrow_dma", "perrow_dma_64k", "perrow_dma_64k_per_sm"):
        tab = p.full((T // 8, 128), 0.5)
        ridx = p.randint(0, T // 8, (dma_rows,))
        sms = build.num_sms(p.device) if p.cuda else 1
        for name, ctas, what in (("perrow_dma_64k", 1, "one CTA"),
                                 ("perrow_dma_64k_per_sm", sms, f"{sms} CTAs (one per SM)")):
            if p.want("perrow_dma", name):
                what += f", a ring of {probes.row_copy_stages(ctas)} bulk copies each"
                ms, rate = p.kernel_case(name, probes.row_copy_sum,
                                         dict(tab=tab, idx=ridx, ctas=ctas),
                                         per=(dma_rows, "ns/row"))
                p.report(name, ms, f"{rate:.2f} ns/row ({what})")
        del tab, ridx

    # ---- (f) strided row slices + lane-permutation product (M) -----------------
    if p.want("strided_permute", "strided_permute_kernel"):
        P = probes.lane_permutation(37, p.device)
        x = p.full((permute_rows, 128), 1.0)
        ms, _ = p.kernel_case("strided_permute_kernel", probes.strided_permute,
                              dict(x=x, P=P, n_out=permute_out))
        p.report("strided_permute_kernel", ms, "9 strided slices + 9 products in the kernel")

    return p.done()


# ---------------------------------------------------------------------------
# wave 8: G (P8) at large table heights with row-broadcast indices

DG_CASES = ((4096, 2048, torch.float32), (8192, 2048, torch.float32),
            (16384, 2048, torch.float32), (32768, 2048, torch.float32),
            (32768, 2048, torch.bfloat16), (8192, 8192, torch.float32))


def wave8(device=None, only=(), keep=None, *, cases=DG_CASES, reps=8):
    p = Probe(8, device, only, keep)
    for rows, n, dt in cases:
        name = f"dg_{rows}r_{n}n_{_name(dt)}"
        if not p.want("dg", name):
            continue
        tbl = p.full((rows, 128), 1.0, dt)
        idx = p.randint(0, rows, (n, 1)).expand(n, 128).contiguous()
        where = []
        ms, rate = p.kernel_case(name, probes.gather, dict(tbl=tbl, idx=idx, axis=0, reps=reps),
                                 per=(n, "ns/row"), where=where)
        read = f"table in {where[0]}" if where else "plain version"
        p.report(name, ms, f"{rate:.2f} ns/row ({reps} reps; {read})")
    return p.done()


WAVES = {1: wave1, 2: wave2, 3: wave3, 4: wave4, 5: wave5, 6: wave6, 7: wave7, 8: wave8}


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, as the records quote it."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi not available"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wave", type=int, action="append", choices=sorted(WAVES),
                    help="run this wave (repeatable; default: all eight)")
    ap.add_argument("--only", default="", help="comma-separated probe groups or names")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain versions")
    for w in WAVES:  # the JAX script's own flags
        ap.add_argument(f"--wave{w}", dest="wave", action="append_const", const=w,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    only = tuple(filter(None, args.only.split(",")))
    out = {}
    for w in sorted(set(args.wave or WAVES)):
        out[w] = WAVES[w](dev, only)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()

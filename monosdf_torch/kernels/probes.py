"""G, S, R, M and C: the kernels of the hash-grid primitive probes.

``scripts/probe_hash_primitives.py`` measured the TPU's gather, scatter,
DMA and on-chip-capacity rates with eight Pallas kernels; the port's probe
(``monosdf_torch/scripts/probe_hash_primitives.py``) measures the card's
with these five:

- **G** (``gather``, ``csrc/probe_gather.cu``; :154 and :998): ``reps``
  dynamic gathers along axis 0 or 1 of a (rows, 128) float32 or bf16
  table, summed in float32; along axis 0 each CTA stages a slice of the
  table's columns, every row, in shared memory where each element is read
  more than once on average and a one-column slice fits one block's
  (``gather_plan``), else the reps read through L2.
- **S** (``scatter_rows``, ``csrc/probe_scatter_rows.cu``; :192 and :534):
  runs of R rows added at their row offsets into a (rows, 128) float32
  accumulator: for offsets the caller says are sorted, one output-stationary
  launch (each row sums the runs that cover it, in run order, and is written
  once; descending offsets trap); else a memset and float4 atomics, each
  warp summing consecutive value rows with the same target first.
- **R** (``row_copy_sum``, ``csrc/probe_row_copy.cu``; :901): the sum of
  ``tab[idx_i, 0]``, each 512-byte row copied into shared memory by its own
  bulk copy, a ring of ``stages`` per CTA with every thread issuing its own
  copies, the CTAs' partials added by the last CTA in the same launch.
- **M** (``strided_permute``, ``csrc/probe_strided_permute.cu``; :936): the
  sum over beta of ``x[beta::8][:n] @ P``, the product in the kernel: a
  warp an output row, each thread 4 lanes of it over the nine beta rows
  (36 float32 FMA chains, each beta's from 0 and added in beta order), x's
  window and P staged in shared memory by bulk copies, P in four chunks of
  k on their own barriers.
- **C** (``capacity``, ``csrc/probe_capacity.cu``; :495 and :853): a
  (rows, 128) output held whole in one CTA's shared memory, zeros with
  ``[0, 0] = 1``, written out by bulk stores; a size above the card's
  per-block maximum is refused.

Each wrapper runs the plain version (``*_plain``) for a CPU tensor and
launches its kernel for a CUDA tensor, counting the launch in
``build.launches``; a refused launch raises. The C signatures are set once
per process.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

GATHER = "probe_gather"
SCATTER = "probe_scatter_rows"
ROW_COPY = "probe_row_copy"
PERMUTE = "probe_strided_permute"
CAPACITY = "probe_capacity"
LANES = 128
_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib(name: str, fn: str, argtypes: tuple):
    """The loaded library and its launch function ``fn``, signature set."""
    lib = build.load(name)
    f = getattr(lib, fn)
    f.restype, f.argtypes = ctypes.c_int, list(argtypes)
    return lib, f


# -- G ----------------------------------------------------------------------


def gather_plain(tbl, idx, axis: int = 0, reps: int = 1):
    """G's function in plain PyTorch: ``reps`` float32 adds of
    take_along_axis(tbl, idx, axis), in order, indices clamped into the
    table as the kernel clamps them."""
    g = torch.take_along_dim(tbl, idx.long().clamp(0, tbl.shape[axis] - 1), dim=axis).float()
    acc = torch.zeros_like(g)
    for _ in range(reps):
        acc = acc + g
    return acc


# csrc/probe_gather.cu's CTA shapes: SLICE_THREADS threads a staged column
# slice, AX1_ROWS rows a CTA along axis 1, L2_THREADS a CTA through L2
SLICE_THREADS = 512
AX1_ROWS = 4
L2_THREADS = 256
_GATHER_ARGS = (_c, _c, _i, _i, _i, _i, _i, _i, _i, _c, _c)


@functools.cache
def gather_limits(index: int) -> tuple:
    """What ``gather_plan`` needs of card ``index``: (sharedMemPerBlockOptin,
    multiProcessorCount, sharedMemPerMultiprocessor,
    maxThreadsPerMultiProcessor), queried once."""
    lib, f = _lib(GATHER, "probe_gather_limits", (_c,))
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        build.check(lib, GATHER, f(vals))
    return tuple(vals)


@functools.lru_cache(maxsize=1024)
def gather_plan(rows: int, n: int, axis: int, reps: int, elem_bytes: int, limits: tuple,
                width: int | None = None) -> tuple:
    """G's launch on a card with ``limits`` (``gather_limits``): (where,
    w, blocks, grid). Axis 1 stages AX1_ROWS rows a CTA. Axis 0 stages
    column slices w wide, the table's every row, where each table element
    is read more than once on average (reps n >= rows) and a one-column
    slice fits one block's shared memory; w is the widest power of two of
    at most 32 bytes a row that fits (``width`` forces a width, and
    staging), and each slice's n output rows go to ``blocks`` CTAs: as
    many as fill the SMs at the CTAs an SM holds, no more than give each
    CTA SLICE_THREADS outputs. Otherwise the reps read through L2 (w 0)."""
    if axis == 1:
        return "shared", 0, 0, -(-rows // AX1_ROWS)
    optin, sms, smem_sm, threads_sm = limits
    if width is None:
        if reps * n < rows or rows * elem_bytes > optin:
            return "l2", 0, 0, -(-n * LANES // L2_THREADS)
        width = 32 // elem_bytes
        while rows * width * elem_bytes > optin:
            width //= 2
    slices = -(-LANES // width)
    fit = max(1, min(threads_sm // SLICE_THREADS, smem_sm // (rows * width * elem_bytes + 1024)))
    blocks = max(1, min(sms * fit // slices, -(-n * width // SLICE_THREADS)))
    return "shared", width, blocks, slices * blocks


def gather(tbl, idx, axis: int = 0, reps: int = 1, where: list | None = None,
           width: int | None = None):
    """(n, 128) float32: ``reps`` gathers of tbl (rows, 128) float32 or
    bf16 at idx (n, 128) int32 along ``axis`` (axis 1: n == rows), summed;
    indices clamped into the table. On the card ``where``, if given, gets
    "shared" or "l2": where the kernel read the table (``gather_plan``;
    ``width``, axis 0 only: stage column slices that wide)."""
    if tbl.device.type == "cpu":
        return gather_plain(tbl, idx, axis, reps)
    dev, rows, n = tbl.device, tbl.shape[0], idx.shape[0]
    if tbl.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tbl: dtype {tbl.dtype}, expected float32 or bfloat16")
    if axis not in (0, 1) or (axis == 1 and n != rows):
        raise ValueError(f"axis {axis} with {n} index rows for {rows} table rows")
    if width is not None and (axis != 0 or not 1 <= width <= LANES):
        raise ValueError(f"width {width}: 1 to {LANES} columns, axis 0 only")
    build.require(tbl, "tbl", tbl.dtype, (rows, LANES), dev)
    build.require(idx, "idx", torch.int32, (n, LANES), dev)
    out = torch.empty(n, LANES, dtype=torch.float32, device=dev)
    place, w, blocks, _ = gather_plan(rows, n, axis, reps, tbl.element_size(),
                                      gather_limits(out.get_device()), width)
    if n:
        lib, f = _lib(GATHER, "probe_gather_launch", _GATHER_ARGS)
        err = f(tbl.data_ptr(), idx.data_ptr(), rows, n, axis, reps,
                int(tbl.dtype == torch.bfloat16), w, blocks, out.data_ptr(), build.stream_ptr(dev))
        build.check(lib, GATHER, err)
        build.launches[GATHER] += 1
    if where is not None:
        where.append(place)
    return out


# -- S ----------------------------------------------------------------------


def run_rows(offs, run: int):
    """The accumulator row of every value row: offs[j] + k, k < run."""
    return (offs.long()[:, None] + torch.arange(run, device=offs.device)).reshape(-1)


def scatter_rows_plain(offs, vals, rows: int, run: int = 1, sorted_offs: bool = False):
    """S's function in plain PyTorch: value rows added in order (any order
    of offsets; ``sorted_offs`` only picks the kernel's pass)."""
    out = torch.zeros(rows, LANES, dtype=torch.float32, device=vals.device)
    return out.index_add_(0, run_rows(offs, run), vals.float())


# value rows a warp of the atomic pass walks: of 8-256, 32 ran P4's
# all-conflict case fastest on an H100, its random case at any span up to
# 128 alike (``scripts/kernel_ab.py --probes --sweep``)
SCATTER_SPAN = 32
_SCATTER_ARGS = (_c, _c, _i, _i, _i, _i, _i, _i, _c, _c)


def scatter_rows(offs, vals, rows: int, run: int = 1, sorted_offs: bool = False,
                 span: int = SCATTER_SPAN):
    """(rows, 128) float32: zeros, then vals[run j + k] (float32 or bf16,
    widened) added into row offs[j] + k for every run j and k < run;
    offs (n_runs,) int32 in [0, rows - run], vals (run n_runs, 128). With
    ``sorted_offs`` the caller says offs is nondecreasing: the card then
    runs the output-stationary pass (the sums in run order; descending
    offsets end the launch with an error, raised at the next sync); else
    the atomic pass over spans of ``span`` value rows."""
    if vals.device.type == "cpu":
        return scatter_rows_plain(offs, vals, rows, run, sorted_offs)
    dev, n = vals.device, offs.shape[0]
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals: dtype {vals.dtype}, expected float32 or bfloat16")
    if run < 1 or rows < run or span < 1:
        raise ValueError(f"run {run} for {rows} rows, span {span}")
    build.require(offs, "offs", torch.int32, (n,), dev)
    build.require(vals, "vals", vals.dtype, (run * n, LANES), dev)
    out = torch.empty(rows, LANES, dtype=torch.float32, device=dev)
    lib, f = _lib(SCATTER, "probe_scatter_rows_launch", _SCATTER_ARGS)
    err = f(offs.data_ptr(), vals.data_ptr(), n, run, rows, int(vals.dtype == torch.bfloat16),
            int(sorted_offs), span, out.data_ptr(), build.stream_ptr(dev))
    build.check(lib, SCATTER, err)
    build.launches[SCATTER] += 1
    return out


# -- R ----------------------------------------------------------------------


def row_copy_sum_plain(tab, idx, ctas: int = 1, stages=None):
    """R's function in plain PyTorch: the sum of tab[idx_i, 0] (float32),
    indices clamped into the table as the kernel clamps them."""
    return tab[idx.long().clamp(0, tab.shape[0] - 1), 0].sum().reshape(1, 1)


def row_copy_stages(ctas: int) -> int:
    """R's ring depth (slots of one row per CTA), the fastest of 32-384 on an
    H100 (``scripts/kernel_ab.py --probes --sweep``): one CTA 256 slots
    (its SM's copies reach their rate there), one CTA per SM or more 128
    each (64 KB; 8.6 MB in flight over 132 SMs)."""
    return 256 if ctas == 1 else 128


_row_copy_ws: dict = {}  # device -> R's workspace: its completion counter and the partials
_ROW_COPY_ARGS = (_c, _i, _c, _i, _i, _i, _c, _c, _c)


def _row_copy_workspace(dev, ctas: int):
    ws = _row_copy_ws.get(dev)
    if ws is None or ws.numel() < 32 + ctas:
        ws = _row_copy_ws[dev] = torch.zeros(32 + max(ctas, 1024), dtype=torch.int32, device=dev)
    return ws


def row_copy_sum(tab, idx, ctas: int = 1, stages=None):
    """(1, 1) float32: sum_i tab[idx_i, 0], tab (rows, 128) float32, idx (n,)
    int32; on the card each row copied whole by its own bulk copy, ``ctas``
    CTAs each over a contiguous slice of idx with a ring of ``stages`` slots
    (a multiple of 32 up to 384; default ``row_copy_stages``), the sums
    added in a fixed order. Calls on one device share a workspace, so they
    run on one stream at a time."""
    if tab.device.type == "cpu":
        return row_copy_sum_plain(tab, idx, ctas, stages)
    dev, rows, n = tab.device, tab.shape[0], idx.shape[0]
    build.require(tab, "tab", torch.float32, (rows, LANES), dev)
    build.require(idx, "idx", torch.int32, (n,), dev)
    if not 1 <= ctas <= max(n, 1):
        raise ValueError(f"ctas {ctas} for {n} rows")
    stages = row_copy_stages(ctas) if stages is None else stages
    if stages % 32 or not 32 <= stages <= 384:
        raise ValueError(f"stages {stages}: a multiple of 32 from 32 to 384")
    ws = _row_copy_workspace(dev, ctas)
    out = torch.empty(1, 1, dtype=torch.float32, device=dev)
    lib, f = _lib(ROW_COPY, "probe_row_copy_launch", _ROW_COPY_ARGS)
    err = f(tab.data_ptr(), rows, idx.data_ptr(), n, ctas, stages, ws.data_ptr(), out.data_ptr(),
            build.stream_ptr(dev))
    build.check(lib, ROW_COPY, err)
    build.launches[ROW_COPY] += 1
    return out


# -- M ----------------------------------------------------------------------


def lane_permutation(step: int = 37, device=None):
    """The probe's 0/1 (128, 128) matrix: P[(l * step) % 128, l] = 1."""
    P = torch.zeros(LANES, LANES, dtype=torch.float32, device=device)
    lanes = torch.arange(LANES, device=device)
    P[(lanes * step) % LANES, lanes] = 1.0
    return P


def strided_permute_plain(x, P, n_out: int = 1024):
    """M's function in plain PyTorch: sum_{beta < 9} x[beta::8][:n_out] @ P
    in beta order."""
    acc = torch.zeros(n_out, LANES, dtype=torch.float32, device=x.device)
    for beta in range(9):
        acc = acc + x[beta::8][:n_out] @ P
    return acc


def strided_permute(x, P, n_out: int = 1024):
    """(n_out, 128) float32: sum_{beta < 9} x[beta::8][:n_out] @ P, x
    (>= 8 n_out + 1, 128) and P (128, 128) float32, both 16-byte aligned;
    on the card the product runs in the kernel, each beta's dot products a
    float32 FMA chain over k from 0, added in beta order (the same bits for
    any P)."""
    if x.device.type == "cpu":
        return strided_permute_plain(x, P, n_out)
    dev = x.device
    if x.shape[0] < 8 * n_out + 1:
        raise ValueError(f"x has {x.shape[0]} rows; {n_out} outputs read {8 * n_out + 1}")
    build.require(x, "x", torch.float32, (x.shape[0], LANES), dev)
    build.require(P, "P", torch.float32, (LANES, LANES), dev)
    if x.data_ptr() % 16 or P.data_ptr() % 16:
        raise ValueError("x and P must be 16-byte aligned (the kernel copies them in bulk)")
    out = torch.empty(n_out, LANES, dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    lib, f = _lib(PERMUTE, "probe_strided_permute_launch", (_c, _c, _i, _c, _c))
    err = f(build.ptr(x), build.ptr(P), n_out, build.ptr(out), build.stream_ptr(dev))
    build.check(lib, PERMUTE, err)
    build.launches[PERMUTE] += 1
    return out


# -- C ----------------------------------------------------------------------


class Refused(RuntimeError):
    """The card refused C's shared-memory request (``where``: at
    cudaFuncSetAttribute or at the launch)."""

    def __init__(self, msg: str, where: str):
        super().__init__(msg)
        self.where = where


def capacity_plain(rows: int, device=None):
    """C's function in plain PyTorch: (rows, 128) float32 zeros, [0, 0] = 1."""
    out = torch.zeros(rows, LANES, dtype=torch.float32, device=device)
    out[0, 0] = 1.0
    return out


_where = ctypes.c_int(0)  # C's refusal stage, written by every launch call
_WHERE_AT = ctypes.addressof(_where)


def capacity(rows: int, device):
    """(rows, 128) float32 zeros with [0, 0] = 1, built whole in one CTA's
    shared memory on the card (``rows * 512`` bytes) and written out by
    bulk stores; raises ``Refused`` when the card will not give one block
    that much."""
    device = torch.device(device)
    if device.type == "cpu":
        return capacity_plain(rows, device)
    out = torch.empty(rows, LANES, dtype=torch.float32, device=device)
    lib, f = _lib(CAPACITY, "probe_capacity_launch", (_c, _i, _c, _c))
    err = f(out.data_ptr(), rows, _WHERE_AT, build.stream_ptr(device))
    if err:
        stage = "cudaFuncSetAttribute" if _where.value == 1 else "launch"
        raise Refused(f"kernel {CAPACITY} refused at {stage}: CUDA error {err} "
                      f"({lib.error_string(err).decode()})", stage)
    build.launches[CAPACITY] += 1
    return out


def device_limits(device) -> dict:
    """The card's on-chip capacities that compare with VMEM, in bytes."""
    lib, f = _lib(CAPACITY, "probe_device_limits", (ctypes.POINTER(ctypes.c_int),))
    vals = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        build.check(lib, CAPACITY, f(vals))
    return dict(zip(("sharedMemPerBlockOptin", "l2CacheSize", "persistingL2CacheMaxSize"), vals))

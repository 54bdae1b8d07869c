"""A torch.profiler trace of the training step and its per-op device time
(the port of scripts/profile_step.py; torch.profiler's device events take
the place of the xplane proto that scripts/xplane_dump.py decodes):

    python -m monosdf_torch.scripts.profile_step [--rays 1024] [--steps 8] [--out exps/profile]
        [--grid --hash_scheme add ...] [--device cpu]

The step is ``bench_step``'s (``bench_step.add_model_args``, with this
script's defaults: the kernel path, ``--diff pallas --sampler pallas --rgb
fused --machinery pallas``, as the JAX script's :25-28); 3 warm-up steps,
then ``--steps`` steps inside one profiler session. Writes the Chrome trace
``<out>/trace.json`` and prints the top 60 device functions by ms a step
with their count a step and the host's top operators, then one JSON line:
ms a step, the device's busy ms and share, the port's kernels' ms and
launches a step, the host's top operators.

Flags of scripts/profile_step.py: ``--rays``, ``--steps``, ``--out``
(default under the working directory, not /tmp), ``--diff``,
``--sampler``, ``--rgb``, ``--machinery``, ``--grid`` and the grid flags
``--table_dtype``, ``--scatter``, ``--hash_scheme``, ``--layout``,
``--fold_impl``, ``--build_impl``, ``--param_flat``, ``--sweep_max_level``,
``--sweep_oct``, ``--gather_chunks``, ``--sampler_iters``: each has its
counterpart. The port adds ``bench_step``'s other model flags and
``--device``.

``device_profile(fn, reps, what)`` is the package's one reader of a
profiler session: ``chip_smoke.py`` profiles its renders and steps with it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

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
# the tensor-core kernels' parts: K1's, K2f's (and its render chunk's
# CUDA-core kernel), K7f's, K3f's, K8a's and K8b's bf16 kernels, K2b's,
# K7b's, K3b's, K8a's and K8b's two passes and their sums
TENSOR_CORE_PARTS = (
    "sdf_mlp_kernel_tc", "sdf_grad_kernel_tc", "sdf_grad_kernel_fma", "sdf_grad_grid_kernel_tc",
    "radiance_norm_kernel_tc", "radiance_split_kernel_tc", "radiance_mlp_kernel_tc",
    *(f"{n}_kernel_{p}" for n in ("sdf_grad_bwd", "sdf_grad_grid_bwd", "radiance_norm_bwd",
                                  "radiance_split_bwd", "radiance_mlp_bwd")
      for p in ("ct", "dw", "sums")))
TOP = 60


def kernel_of(kernel: str, name: str) -> bool:
    """Whether the device function ``name`` belongs to ``kernel`` (a name of
    build.SOURCES, or reduce_partials)."""
    return any(p in name for p in DEVICE_NAMES.get(kernel, (f"{kernel}_kernel",)))


def _session(fn, reps: int, cuda: bool):
    """One profiler session over ``reps`` calls of fn: (profile, wall ms a
    call by CUDA events, or by the host clock on the CPU)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if not cuda:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / reps
        return prof, ms
    acts.append(torch.profiler.ProfilerActivity.CUDA)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return prof, start.elapsed_time(end) / reps


def device_profile(fn, reps: int, what: str, device=None, trace=None, top: int = 0) -> dict:
    """Device time per kernel over ``reps`` calls of fn (torch.profiler,
    the session's sums), the kernels' device events and launches counted
    meanwhile, the wall time per call (CUDA events), and the device's busy
    share. One call of fn runs first, outside the session. Raises where a
    session on the card recorded no device time (after three sessions).
    ``device``: 'cpu' profiles the host alone (no device fields are
    measured: busy 0). ``trace``: a path for the session's Chrome trace.
    Returns ms, device_busy_ms, busy_share, kernels_ms (each kernel
    of build.SOURCES and reduce_partials), nccl_ms, nccl_events,
    nccl_host_events, device_events_per_call, host_top_ms,
    kernel_events, launches (over the session), tensor_core_parts_ms,
    other_ms, other_top_ms, and with ``top`` device_top (the ``top``
    largest device functions' ms and count a call)."""
    from ..kernels import build

    cuda = device is None or torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize()
    for _ in range(3):  # again where the session recorded no device event
        before = dict(build.launches)
        prof, ms = _session(fn, reps, cuda)
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
        if busy > 0 or not cuda:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device time ({what})")
    if trace is not None:
        prof.export_chrome_trace(trace)
    launched = {k: v - before[k] for k, v in build.launches.items() if v != before[k]}
    count = {e.key: e.count for e in dev_events}
    # the bf16 backward passes (*_kernel_ct, *_kernel_dw, *_kernel_sums)
    # count under their kernel
    groups = (*build.SOURCES, "reduce_partials")
    kern = {n: sum(v for k, v in per_name.items() if kernel_of(n, k)) for n in groups}
    events = {n: sum(c for k, c in count.items() if kernel_of(n, k)) for n in groups}
    other: dict = {}  # by the first 60 characters of the kernel's name
    for k, v in per_name.items():
        if not any(kernel_of(n, k) for n in groups):
            other[k[:60]] = other.get(k[:60], 0.0) + v
    kern_parts = {n: sum(v for k, v in per_name.items() if n in k) for n in TENSOR_CORE_PARTS}
    # the host's side: the operators' own CPU time
    host = {}
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key[:60]] = host.get(e.key[:60], 0.0) + e.self_cpu_time_total / 1e3 / reps
    # the collectives' kernels (NCCL's all-reduce of a DDP step)
    nccl = [k for k in per_name if "nccl" in k.lower()]
    nccl_host = sum(e.count for e in averages
                    if e.device_type == torch.autograd.DeviceType.CPU and "nccl" in e.key.lower())
    out = {"ms": ms, "device_busy_ms": busy, "busy_share": busy / ms, "kernels_ms": kern,
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
    if top:
        out["device_top"] = [{"name": k, "ms": v, "count": count[k] / reps}
                             for k, v in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]]
    return out


def main(argv=None) -> dict:
    from . import bench_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join("exps", "profile"),
                    help="directory of the Chrome trace")
    bench_step.add_model_args(ap, kernels=True)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    run = bench_step.setup(args)
    for _ in range(3):  # warm
        run.step()
    run.sync()
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "trace.json")
    prof = device_profile(run.step, args.steps, "profile_step", run.device, trace, TOP)
    print(f"== device functions (top {TOP} by ms a step over {args.steps} steps)")
    for row in prof["device_top"]:
        print(f"{row['ms']:9.3f} ms/step {row['count']:7.1f}/step  {row['name'][:140]}")
    print("== host operators (top 6 by their own CPU ms a step)")
    for name, ms in prof["host_top_ms"].items():
        print(f"{ms:9.3f} ms/step  {name}")
    kernels = {k: v for k, v in prof["kernels_ms"].items() if v}
    line = {
        "rays": args.rays, "steps": args.steps, "grid": args.grid, "device": run.name,
        "trace": trace,
        "ms_per_step": prof["ms"], "device_busy_ms": prof["device_busy_ms"],
        "busy_share": prof["busy_share"],
        "kernels_ms": kernels,
        "kernel_events_per_step": {k: v / args.steps for k, v in prof["kernel_events"].items()},
        "launches_per_step": {k: v / args.steps for k, v in prof["launches"].items()},
        "other_ms": prof["other_ms"],
        "device_events_per_step": prof["device_events_per_call"],
        "host_top_ms": prof["host_top_ms"],
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

"""Stage breakdown of the training step on the card (the port of
scripts/bench_breakdown.py): (a) the sampler alone, (b) the training
forward (``render_rays(training=True)``), (c) the loss's forward and
backward, no optimizer, (d) the full step (forward, backward, Adam).
Differences between stages isolate them.

    python -m monosdf_torch.scripts.bench_breakdown [--rays 1024] [--diff pallas] [--iters 20]
        [--sampler pallas --machinery pallas --rgb fused] [--grid ...] [--device cpu]

The model, batch and draws are ``bench_step``'s (``bench_step.setup``).
Each stage runs once, then over ``--profile_reps`` calls inside a profiler
session (``profile_step.device_profile``: ``busy_ms``, the device's busy ms
a call), then ``--iters`` times from the host clock to a synchronise
(``ms``); ``busy_share`` is busy_ms over ms, and ``ms`` less ``busy_ms``
the host's share. On the CPU the stage runs once before its timed calls
and the device fields are null. Prints one JSON line a stage: ``stage``
and ``ms`` (the JAX script's keys), ``busy_ms``, ``busy_share``,
``launches`` (the port's kernels a call, counted over the timed calls) and
``device``.

Flags of scripts/bench_breakdown.py: ``--rays``, ``--diff`` (default
``pallas``, as there) and ``--iters`` have their counterparts. The JAX
script fixes the other backends at its plain defaults; the port takes
``bench_step``'s model flags for them (the same defaults), so that the
sampler, the radiance and the grid model's stages can run on their kernels
(``--sampler pallas --machinery pallas --rgb fused``; ``--grid`` with the
grid flags). The port adds ``--profile_reps`` and ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time

from ..kernels import build
from ..losses import LossConfig
from ..models.monosdf import render_rays, sample_rays
from ..train.step import step_losses
from . import bench_step
from .profile_step import device_profile


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile_reps", type=int, default=3,
                    help="calls of each stage in its profiler session")
    bench_step.add_model_args(ap)
    ap.set_defaults(diff="pallas")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    run = bench_step.setup(args)
    model, cfg, rays = run.model, run.cfg, run.batch["rays"]
    gen, lc = run.generator, LossConfig()

    def sampler():
        return sample_rays(model, cfg, rays, training=True, generator=gen)

    def forward():  # under grad: the training forward, its graph dropped
        return render_rays(model, cfg, rays, training=True, generator=gen)["rgb_values"]

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        loss = step_losses(model, cfg, lc, run.batch, 0, generator=gen)["loss"]
        loss.backward()
        return loss

    stages = (("sampler", sampler), ("forward (sampler+sdf+radiance+render)", forward),
              ("fwd+bwd (no optimizer)", fwd_bwd), ("full step (fwd+bwd+opt)", run.step))
    lines = []
    for name, fn in stages:
        # the profiler session first: its first call (outside the session)
        # is the stage's warm-up; on the CPU one plain call
        if run.device.type == "cuda":
            busy = device_profile(fn, args.profile_reps, name, run.device)["device_busy_ms"]
        else:
            fn()
            busy = None
        run.sync()
        before = dict(build.launches)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        run.sync()
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        launches = {k: (v - before[k]) / args.iters for k, v in build.launches.items()
                    if v != before[k]}
        line = {"stage": name, "ms": ms, "busy_ms": busy,
                "busy_share": None if busy is None else busy / ms, "launches": launches,
                "rays": args.rays, "grid": args.grid, "device": run.name}
        print(json.dumps(line), flush=True)
        lines.append(line)
    model.zero_grad(set_to_none=True)
    return lines


if __name__ == "__main__":
    main()

"""The port's measurement scripts (``monosdf_torch/scripts``: bench_step,
bench_breakdown, profile_step, bench_multihost, bench_sampler_machinery,
bench_sdf_grad_kernel) on the CPU.

* ``bench_step``'s model at the kernel flags is ``cli/eval.py
  bench_config`` field for field (MLP, and with the grid flags the grid
  model), and each grid flag sets the ``HashGridConfig`` field of the JAX
  script's name (scripts/bench_step.py:85-100);
* each script's ``main`` runs with ``--device cpu`` at a small size (the
  plain versions; float32 and one sampler round where the script takes
  ``bench_step``'s model flags) and prints the JSON keys of its JAX
  counterpart;
* without ``--device cpu`` each raises on a machine without a card (no
  fallback to the CPU).

The card runs them at full size in ``chip_smoke.py``'s phase 17. This
file imports no JAX.
"""

import json

import pytest
import torch

from monosdf_torch.cli.eval import bench_config
from monosdf_torch.scripts import (bench_breakdown, bench_multihost, bench_sampler_machinery,
                                   bench_sdf_grad_kernel, bench_step, profile_step)

torch.set_num_threads(2)  # leave the cores to the other test workers

# bench_config(True)'s grid model through bench_step's flags
GRID_FLAGS = ("--grid", "--hash_scheme", "add", "--layout", "quad", "--scatter", "fold",
              "--fold_impl", "pallas", "--build_impl", "pallas", "--param_flat",
              "--gather_chunks", "4", "--sweep_oct", "--sweep_max_level", "6",
              "--sampler_iters", "4", "--rgb", "jnp")
# a small run of the scripts that take bench_step's model flags
SMALL = ("--rays", "32", "--f32", "--sampler_iters", "1", "--device", "cpu")


def _bench_args(argv):
    return bench_step.parser().parse_args(list(argv))


@pytest.mark.parametrize("grid", [False, True], ids=["mlp", "grids"])
def test_bench_step_at_the_kernel_flags_is_bench_config(grid):
    argv = (*bench_step.KERNEL_FLAGS, *(GRID_FLAGS if grid else ()))
    assert bench_step.model_config(_bench_args(argv)) == bench_config(grid)
    # the defaults are the plain versions, as the JAX script's
    plain = bench_step.model_config(_bench_args(()))
    assert (plain.diff_backend, plain.sampler_backend, plain.rgb_backend,
            plain.sampler.machinery) == ("jnp",) * 4


# flag, value, the HashGridConfig field it sets (scripts/bench_step.py:88-100)
GRID_FIELDS = [("--table_dtype", "float32", "table_dtype", "float32"),
               ("--scatter", "rows", "scatter_impl", "rows"),
               ("--hash_scheme", "add", "hash_scheme", "add"),
               ("--layout", "quad", "layout", "quad"),
               ("--fold_impl", "pallas", "fold_impl", "pallas"),
               ("--build_impl", "pallas", "build_impl", "pallas"),
               ("--param_flat", None, "param_flat", True),
               ("--gather_chunks", "3", "gather_chunks", 3)]


@pytest.mark.parametrize("flag,value,field,want", GRID_FIELDS, ids=[f[0] for f in GRID_FIELDS])
def test_each_grid_flag_sets_its_hashgrid_field(flag, value, field, want):
    argv = ("--grid", flag) if value is None else ("--grid", flag, value)
    cfg = bench_step.model_config(_bench_args(argv))
    assert getattr(cfg.implicit.grid, field) == want
    assert getattr(bench_step.model_config(_bench_args(("--grid",))).implicit.grid, field) != want
    # --sweep_oct carries --sweep_max_level into sweep_oct_levels, as the JAX script
    oct_ = bench_step.model_config(_bench_args(("--grid", "--sweep_oct", "--sweep_max_level",
                                                "6")))
    assert oct_.implicit.grid.sweep_oct_levels == 6 and oct_.sweep_max_level == 6


def _lines(capsys) -> list:
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_bench_step_runs_on_the_cpu(capsys):
    out = bench_step.main([*bench_step.KERNEL_FLAGS, *SMALL, "--warmup", "1", "--iters", "1",
                           "--nofold", "--nofused_opt"])
    (line,) = _lines(capsys)
    assert line == json.loads(json.dumps(out))
    # scripts/bench_step.py:173-186's keys, less unroll (left out)
    assert {"rays", "diff", "sampler", "rgb", "sweep_pe", "machinery", "grid", "table_dtype",
            "scatter", "hash_scheme", "layout", "ms_per_step", "rays_per_s", "compile_s",
            "loss_first", "loss_last"} <= line.keys()
    assert line["nofold"] and line["nofused_opt"] and line["device"] == "cpu"
    assert line["ms_per_step"] > 0 and line["launches_per_step"] == {}


def test_bench_breakdown_runs_on_the_cpu(capsys):
    stages = bench_breakdown.main([*SMALL, "--iters", "1"])
    assert _lines(capsys) == json.loads(json.dumps(stages))
    assert [s["stage"] for s in stages] == [
        "sampler", "forward (sampler+sdf+radiance+render)", "fwd+bwd (no optimizer)",
        "full step (fwd+bwd+opt)"]
    assert all(s["ms"] > 0 and s["busy_ms"] is None for s in stages)


def test_profile_step_runs_on_the_cpu(capsys, tmp_path):
    line = profile_step.main([*SMALL, "--rays", "8", "--steps", "1", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "ms/step" in out and json.loads(out.splitlines()[-1])["steps"] == 1
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert line["ms_per_step"] > 0 and line["device_busy_ms"] == 0 and line["host_top_ms"]


def test_bench_multihost_runs_on_the_cpu(capsys):
    line = bench_multihost.main(["--n_devices", "1", "--tiny", "--device", "cpu",
                                 "--rays_per_device", "8", "--warmup", "1", "--iters", "1"])
    assert _lines(capsys) == [line]
    # scripts/bench_multihost.py:110-122's keys
    assert {"n_processes", "n_devices", "ms_per_step", "rays_per_sec",
            "rays_per_sec_per_device", "backend"} <= line.keys()
    assert (line["n_devices"], line["backend"], line["collective"]) == (1, "cpu", "gloo")
    assert not torch.distributed.is_initialized()


def test_micro_timings_run_on_the_cpu(capsys):
    rows = bench_sampler_machinery.main(["--rays", "4", "--iters", "1", "--device", "cpu"])
    k2 = bench_sdf_grad_kernel.main(["--n", "16", "--iters", "1", "--device", "cpu"])
    assert _lines(capsys) == [*rows, k2]
    assert [r["op"] for r in rows] == ["cumsum"] * 2 + ["error_bound x11"] * 5 + [
        "merge sort"] * 4 + ["sample_pdf"] * 5 + ["final sort"]
    assert all(r["ms"] > 0 for r in rows)
    # scripts/bench_sdf_grad_kernel.py:86-94's keys, less block and sched (left out)
    assert {"n", "dtype", "save_z", "fwd_ms", "fwd_bwd_ms", "fwd_tflops",
            "fwd_bwd_tflops"} <= k2.keys()
    assert 0 < k2["bound_ms_fwd"] < k2["bound_ms_fwd_bwd"]


MAINS = {
    "bench_step": (bench_step.main, ["--rays", "2"]),
    "bench_breakdown": (bench_breakdown.main, ["--rays", "2"]),
    "profile_step": (profile_step.main, ["--rays", "2"]),
    "bench_multihost": (bench_multihost.main, ["--tiny"]),
    "bench_sampler_machinery": (bench_sampler_machinery.main, ["--rays", "2"]),
    "bench_sdf_grad_kernel": (bench_sdf_grad_kernel.main, ["--n", "2"]),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_no_script_falls_back_to_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)

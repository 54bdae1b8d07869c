"""The port's quality evidence run (``monosdf_torch/scripts/quality_run.py``)
against the JAX package's ``scripts/quality_run.py``, on the CPU.

* The four ground-truth samplers (sphere, union, torus, room) bit for bit
  equal to the JAX script's, imported by path (its top level needs only
  numpy).
* One ``quality_run.main([... "--cpu" ...])`` end to end on a 4-view 32x32
  sphere scene from the port's generator, with an overlay that cuts the
  widths and runs 3 steps, a mesh at 24 and 2,000 surface samples: the
  results carry the JAX evidence run's keys (``docs/quality/results.json``)
  and ``device``, the curve the logged rows, and the artifacts land in the
  given directory, nothing under ``docs/``.
* ``scripts/seed_study.py`` on the same kind of scene and overlay, from
  seed 0 to step 3: one start with its mesh's vertices and the least SDF
  on a 9^3 lattice, and its curve (the port's own study; no JAX
  counterpart).

Tensorboard is taken out of reach (the metrics go to the JSONL log), as in
tests/test_torch_trainer.py. The file takes about 10 s of CPU alone.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monosdf_torch.scripts import quality_run as tq
from monosdf_torch.scripts import seed_study

torch.set_num_threads(2)  # leave the cores to the other test workers

REPO = Path(__file__).resolve().parent.parent
TINY = """
train{ num_pixels = 64, checkpoint_freq = 1, plot_freq = 100000, split_n_pixels = 512 }
plot{ resolution = 24 }
dataset{ img_res = [32, 32] }
model{ feature_vector_size = 16, implicit_network{ dims = [64, 64, 64, 64], skip_in = [2] },
 rendering_network{ dims = [16, 16] },
 ray_sampler{ N_samples = 16, N_samples_eval = 32, N_samples_extra = 8, max_total_iters = 2 } }
"""


@pytest.fixture(scope="module")
def jq():
    spec = importlib.util.spec_from_file_location("jax_quality_run",
                                                  REPO / "scripts" / "quality_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sampler", ["sphere", "union", "torus", "room"])
def test_gt_samplers_bit_equal(jq, sampler):
    for n, seed in ((5000, 0), (777, 3)):
        if sampler == "sphere":
            a, b = jq.fibonacci_sphere(n, jq.GT_RADIUS), tq.fibonacci_sphere(n, tq.GT_RADIUS)
            np.testing.assert_array_equal(b, a)
            continue
        fa, fb = getattr(jq, f"{sampler}_surface"), getattr(tq, f"{sampler}_surface")
        for x, y in zip(fa(n, seed=seed), fb(n, seed=seed)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(y, x)


def test_last_pass_keeps_a_resumed_curve():
    rows = [{"iter": i} for i in (1, 50, 1, 50, 100, 101, 150)]  # a re-run, then a resume at 100
    assert [r["iter"] for r in tq.last_pass(rows)] == [1, 50, 100, 101, 150]


def test_quality_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    overlay = tmp_path / "tiny.conf"
    overlay.write_text(TINY)
    docs = sorted(p.name for p in (REPO / "docs").iterdir())
    out = tmp_path / "artifacts"
    results, curve = tq.main([
        "--root", str(tmp_path / "q"), "--iters", "3", "--res", "32", "--views", "4",
        "--mesh_res", "24", "--gt_samples", "2000", "--cpu",
        "--conf", str(REPO / "confs" / "synth_sphere_quality.conf"),
        "--conf_add", str(overlay), "--out_dir", str(out)])
    jax_keys = json.load(open(REPO / "docs" / "quality" / "results.json"))["results"]
    assert set(results) == set(jax_keys) | {"device"} and results["device"] == "cpu"
    assert results["iters"] == 3 and results["mesh_verts"] > 0
    assert all(np.isfinite(results[k]) for k in ("chamfer_l1", "f_score@5cm",
                                                  "normal_consistency", "eval_psnr_mean"))
    assert [r["iter"] for r in curve] == [1]  # the log's rows at the curve's iters
    saved = json.load(open(out / "results.json"))
    assert saved["results"] == results and saved["curve"] == curve
    assert sorted(os.listdir(out)) == ["results.json", "sphere_surface_24.ply"]
    assert sorted(p.name for p in (REPO / "docs").iterdir()) == docs


def test_seed_study_on_the_cpu(tmp_path, monkeypatch):
    from monosdf_torch.scripts import make_synthetic_scene

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    overlay = tmp_path / "tiny.conf"
    overlay.write_text(TINY)
    make_synthetic_scene.main([str(tmp_path / "data"), "--n", "4", "--res", "32",
                               "--radius", str(tq.GT_RADIUS)])
    out = tmp_path / "seeds.json"
    recs = seed_study.main([
        "--conf", str(REPO / "confs" / "synth_sphere_quality.conf"), "--conf_add", str(overlay),
        "--data_root", str(tmp_path / "data"), "--exps_root", str(tmp_path / "exps"),
        "--seeds", "0", "--iters", "3", "--grid", "9", "--device", "cpu", "--out", str(out)])
    (rec,) = recs
    assert rec["start"] == "seed0" and rec["iters"] == 3 and rec["grid"] == 9
    (epoch,) = rec["epochs"]
    assert epoch["iter"] == 3 and epoch["verts"] >= 0 and np.isfinite(epoch["sdf_min"])
    assert [r["iter"] for r in rec["curve"]] == [1]
    assert set(rec["curve"][0]) == {"iter", "loss", "psnr", "beta"}
    assert json.load(open(out)) == recs

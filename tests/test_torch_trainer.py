"""Parity of the port's trainer, checkpoints and CLIs' conf path with the
JAX package.

* Checkpoints, JAX to port: a JAX ``Trainer`` trains 3 steps and saves
  (the fused ``FlatAdamState``), in MLP mode and in grid mode with the
  ``param_flat`` table; the per-leaf and partition flavors come from JAX's
  ``make_optimizer(fused=False)`` and one ``update`` on seeded gradients.
  The port restores each: parameters and moments bit-equal, step and
  learning rate equal (rtol 1e-6: float32 against float64 powers).
* One more step: from the restored state and the JAX run's next batch,
  with the draws of JAX's key tree injected, the port's step against JAX's
  (parameters at 2e-4, PERFORMANCE.md's step bar, the loss at 2e-5).
* Checkpoints, port to JAX: the port's checkpoint through JAX's
  ``restore_state`` into each flavor, bit-equal.
* The trainer loop (the port's counterparts of tests/test_trainer.py's
  cases), ``sample_batch`` bit-equal to JAX's in pixel and image mode, and
  both CLIs' ``--conf`` on the CPU (the eval CLI reading a JAX checkpoint).

Sizes are tests/test_trainer.py's ``tiny_exp``; the backends are the plain
ones (the JAX step compiles once for each mode). Both packages' runs write
their metrics to the JSONL log: tensorboard is taken out of reach (where it
is installed with TensorFlow, importing it alone costs seconds).
"""

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import monosdf_tpu.config as jc
import monosdf_tpu.train.checkpoint as jck
import monosdf_tpu.train.optim as joptim
from monosdf_tpu.data import make_synthetic_sphere_scene
from monosdf_tpu.train.step import TrainState, init_train_state
from monosdf_tpu.train.step import make_train_step as make_jax_step
from monosdf_tpu.train.trainer import Trainer as JTrainer
import monosdf_torch.config as tc
import monosdf_torch.models.monosdf as tm
import monosdf_torch.train.checkpoint as tck
from monosdf_torch.cli import eval as teval
from monosdf_torch.cli import train as ttrain
from monosdf_torch.params import flatten_tree
from monosdf_torch.train import make_optimizer, make_train_step
from monosdf_torch.train.trainer import Trainer as TTrainer
from torch_parity import jax_draws, jit_ref, torch_draws

torch.set_num_threads(2)  # leave the cores to the other test workers


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def conf_dict(grid: bool = False, **train) -> dict:
    """tests/test_trainer.py tiny_exp as a conf tree (plain backends,
    float32); ``grid``: a 4-level hash grid with the flat table."""
    imp = {"dims": [32, 32], "multires": 4, "inside_outside": False, "bias": 0.5}
    if grid:
        imp.update(num_levels=4, level_dim=2, base_size=16, end_size=64, logmap=12,
                   table_dtype="float32", param_flat=True, divide_factor=1.1)
    return {
        "train": {"expname": "unit", "learning_rate": 1e-3, "num_pixels": 32,
                  "split_n_pixels": 64, "max_total_iters": 40, "checkpoint_freq": 1,
                  "plot_freq": 0, **train},
        "plot": {"resolution": 32},
        "model": {"feature_vector_size": 16, "scene_bounding_sphere": 1.1, "Grid_MLP": grid,
                  "implicit_network": imp,
                  "rendering_network": {"dims": [32, 32], "multires_view": 2},
                  "ray_sampler": {"N_samples": 8, "N_samples_eval": 16, "N_samples_extra": 4,
                                  "max_total_iters": 2, "intersection": "cube"}},
    }


def hocon(conf: dict) -> str:
    """A conf tree as HOCON text (JSON values under top-level keys)."""
    return "".join(f"{k} = {json.dumps(v)}\n" for k, v in conf.items())


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_sphere_scene(n_images=2, img_res=8)


def _flat(tree) -> dict:
    return {k.replace("/", "."): np.asarray(v) for k, v in
            flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def jax_runs(scene, tmp_path_factory):
    """mode -> (JAX Trainer after 3 steps and its save, its conf): the
    JAX train step compiles once a mode."""
    runs = {}
    for mode in ("mlp", "grid"):
        conf = conf_dict(mode == "grid", max_total_iters=3, checkpoint_freq=100)
        with pytest.MonkeyPatch.context() as mp:  # its metrics to the JSONL log too
            mp.setitem(sys.modules, "torch.utils.tensorboard", None)
            tr = JTrainer(jc.build_configs(conf), scene,
                          exps_root=str(tmp_path_factory.mktemp(mode)), seed=0,
                          timestamp="20260101-000000")
        # the trainer's own step, compiled with the references' options
        tr.step_fn = jit_ref(make_jax_step(tr.exp.model, tr.exp.loss, tr.optimizer),
                             donate_argnums=(0,))
        tr.train(log_every=10)
        runs[mode] = (tr, conf)
    return runs


def port_state(conf: dict, **implicit):
    """(model, optimizer) of a conf on the CPU, ``implicit`` overriding
    implicit_network fields."""
    if implicit:
        conf = {**conf, "model": {**conf["model"], "implicit_network": {
            **conf["model"]["implicit_network"], **implicit}}}
    exp = tc.build_configs(conf)
    model = tm.init_monosdf(exp.model, seed=1, device="cpu")
    return model, make_optimizer(exp.optim, model.named_parameters()), exp


def _assert_moments(opt, model, count, mu, nu):
    for n, p in model.named_parameters():
        st = opt.adam.state[p]
        assert float(st["step"]) == count, n
        assert np.array_equal(st["exp_avg"].numpy(), mu[n].reshape(p.shape)), n
        assert np.array_equal(st["exp_avg_sq"].numpy(), nu[n].reshape(p.shape)), n


def _assert_lr(opt, jexp, step):
    factor = {"encoding": jexp.optim.lr_factor_for_grid}
    want = [float(joptim._schedule(jexp.optim, factor.get(g, 1.0))(step)) for g in
            (("encoding", "net", "density") if jexp.optim.grid_mode else ("net",))]
    got = [g["lr"] for g in opt.adam.param_groups]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert opt.schedule.last_epoch == step and opt.schedule.get_last_lr() == got


# -- checkpoints, JAX to port -----------------------------------------------

@pytest.mark.parametrize("mode", ["mlp", "grid", "grid-table-2d"])
def test_jax_fused_checkpoint_restores_into_the_port(jax_runs, mode):
    """The fused flavor (the default of every conf): raveled moments in
    sorted-key order with a zero-padded tail. ``grid-table-2d``: the flat
    table restored into a (T, C) table."""
    tr, conf = jax_runs[mode.split("-")[0]]
    extra = {"param_flat": False} if mode == "grid-table-2d" else {}
    model, opt, _ = port_state(conf, **extra)
    payload = tck.load_checkpoint(tr.ckpt_dir)
    assert payload["opt_flavor"] == "FlatAdamState"
    assert tck.restore_state(model, opt, payload, strict=True) == 3
    js = jax.device_get(tr.state)
    assert js.opt_state.mu.shape[0] % 1024 == 0  # the padded flat layout
    jp = _flat(js.params)
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), jp[n].reshape(p.shape)), n
    if mode == "grid-table-2d":
        assert model.implicit.encoding.embeddings.dim() == 2
    flat, unravel = ravel_pytree(js.params)
    n = flat.shape[0]
    _assert_moments(opt, model, 3, _flat(unravel(js.opt_state.mu[:n])),
                    _flat(unravel(js.opt_state.nu[:n])))
    _assert_lr(opt, tr.exp, 3)


@pytest.mark.parametrize("mode", ["mlp", "grid"])
def test_jax_optax_flavors_restore_into_the_port(jax_runs, tmp_path, mode):
    """Per-leaf optax.adam (MLP mode) and grid mode's multi_transform
    partitions, each after one update on seeded gradients."""
    tr, conf = jax_runs[mode]
    opt = joptim.make_optimizer(dataclasses.replace(tr.exp.optim, fused=False))
    params = jax.device_get(tr.state.params)
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32),
                                   params)
    _, st = jit_ref(opt.update)(grads, jit_ref(opt.init)(params), params)
    jck.save_checkpoint(str(tmp_path), TrainState(params, st, jnp.int32(1)), epoch=0)
    payload = tck.load_checkpoint(str(tmp_path))
    assert payload["opt_flavor"] == ("PartitionState" if mode == "grid" else "tuple")
    model, topt, _ = port_state(conf)
    assert tck.restore_state(model, topt, payload, strict=True) == 1
    if mode == "grid":
        mu, nu = {}, {}
        for g in st.inner_states.values():
            adam = g.inner_state[0]
            mu.update({k: v for k, v in _flat_masked(adam.mu).items()})
            nu.update({k: v for k, v in _flat_masked(adam.nu).items()})
    else:
        mu, nu = _flat(st[0].mu), _flat(st[0].nu)
    assert set(mu) == {n for n, _ in model.named_parameters()}
    _assert_moments(topt, model, 1, mu, nu)
    _assert_lr(topt, tr.exp, 1)


def _flat_masked(tree) -> dict:
    """A partition's moment tree without its masked leaves."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: type(x).__name__ == "MaskedNode")
    return {".".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves
            if type(v).__name__ != "MaskedNode"}


def test_unknown_classes_and_missing_moments(tmp_path):
    import collections
    import pickle

    with open(tmp_path / "latest.ckpt", "wb") as f:
        pickle.dump({"opt_state": collections.Counter()}, f)
    with pytest.raises(pickle.UnpicklingError, match="does not read"):
        tck.load_checkpoint(str(tmp_path))
    model, opt, _ = port_state(conf_dict())
    payload = {"params": jax.tree_util.tree_map(np.asarray, _tree(model)),
               "opt_state": {"momentum": np.zeros(3, np.float32)}, "step": 7, "epoch": 0}
    with pytest.warns(UserWarning, match="moments reset"):
        assert tck.restore_state(model, opt, payload) == 7
    assert not opt.adam.state and opt.schedule.last_epoch == 7
    with pytest.raises(ValueError, match="moments"):
        tck.restore_state(model, opt, payload, strict=True)


def _tree(model):
    from monosdf_torch.params import params_to_tree

    return params_to_tree(model)


# -- one more step, and the port's checkpoint into JAX -----------------------

def _batch(scene, seed):
    idx = np.random.default_rng(seed).integers(0, scene["rays_o"].shape[0], size=32)
    return {"rays": {k: scene[k][idx] for k in ("rays_o", "rays_d", "depth_scale", "pose")},
            "gt": {k: scene[k][idx] for k in ("rgb", "depth", "normal", "mask")}}


@pytest.mark.parametrize("mode", ["mlp", "grid"])
def test_next_step_and_port_checkpoint_into_jax(jax_runs, scene, tmp_path, mode):
    tr, conf = jax_runs[mode]
    model, opt, texp = port_state(conf)
    tck.restore_state(model, opt, tck.load_checkpoint(tr.ckpt_dir), strict=True)
    batch, key = _batch(scene, 9), jax.random.PRNGKey(11)
    state = jax.tree_util.tree_map(jnp.array, tr.state)  # the step donates its input
    jstate, jm = tr.step_fn(state, jax.tree_util.tree_map(jnp.asarray, batch), key)
    tb = {k: {kk: torch.from_numpy(np.ascontiguousarray(v)) for kk, v in batch[k].items()}
          for k in ("rays", "gt")}
    step = make_train_step(texp.model, texp.loss, opt)
    tmetrics = step(model, tb, draws=torch_draws(jax_draws(key, 32, tr.exp.model)))
    np.testing.assert_allclose(float(tmetrics["loss"]), float(jm["loss"]), rtol=2e-5)
    jp = _flat(jax.device_get(jstate.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[n].reshape(p.shape), atol=2e-4,
                                   rtol=0, err_msg=n)

    # the port's checkpoint after that step, restored by JAX into each flavor
    tck.save_checkpoint(str(tmp_path), model, opt, epoch=1)
    payload = jck.load_checkpoint(str(tmp_path))
    tp = {n: p.detach().numpy() for n, p in model.named_parameters()}
    tmu = {n: opt.adam.state[p]["exp_avg"].numpy() for n, p in model.named_parameters()}
    for fused in (True, False):
        jopt = joptim.make_optimizer(dataclasses.replace(tr.exp.optim, fused=fused))
        live = init_train_state(jax.device_get(tr.state.params), jopt)
        restored = jck.restore_state(live, payload, strict=True)
        assert int(restored.step) == 4
        rp = _flat(restored.params)
        for n in tp:
            assert np.array_equal(rp[n].reshape(tp[n].shape), tp[n]), n
        node = jck._find_adam_node(jax.device_get(restored.opt_state))
        if fused:
            flat, unravel = ravel_pytree(restored.params)
            rmu = _flat(unravel(node.mu[:flat.shape[0]]))
            assert int(node.count) == 4 and not np.any(node.mu[flat.shape[0]:])
        elif mode == "grid":
            rmu = {}
            for g in restored.opt_state.inner_states.values():
                assert int(g.inner_state[0].count) == 4
                rmu.update(_flat_masked(g.inner_state[0].mu))
        else:
            rmu = _flat(node.mu)
            assert int(node.count) == 4
        for n in tmu:
            assert np.array_equal(rmu[n].reshape(tmu[n].shape), tmu[n]), n


# -- the trainer loop --------------------------------------------------------

def _exp(**train):
    return tc.build_configs(conf_dict(**train))


def _trainer(tmp_path, scene, exp, **kw):
    return TTrainer(exp, scene, exps_root=str(tmp_path), seed=0, device="cpu",
                    **{"timestamp": "20260101-000000", **kw})


def test_train_writes_metrics_checkpoints_and_gc(tmp_path, scene):
    tr = _trainer(tmp_path, scene, _exp(max_total_iters=40))
    tr.train(log_every=10)
    rows = [json.loads(l) for l in open(os.path.join(tr.run_dir, "metrics.jsonl"))]
    assert len(rows) >= 4 and {"iter", "loss", "psnr", "rays_per_sec", "beta"} <= set(rows[-1])
    assert np.isfinite(rows[-1]["loss"])
    ckpts = sorted(glob.glob(os.path.join(tr.ckpt_dir, "*.ckpt")))
    numbered = [c for c in ckpts if os.path.basename(c) != "latest.ckpt"]
    assert os.path.exists(os.path.join(tr.ckpt_dir, "latest.ckpt"))
    assert len(numbered) == 3, numbered
    scalars = os.path.join(tr.plot_dir, "logs", "scalars.jsonl")
    assert any(json.loads(l)["tag"] == "train/alpha" for l in open(scalars))


def test_resume_continues_from_saved_step(tmp_path, scene):
    exp = _exp(max_total_iters=20)
    tr = _trainer(tmp_path, scene, exp)
    tr.train(log_every=10)
    assert tr.step == 20
    tr2 = TTrainer(exp, scene, exps_root=str(tmp_path), seed=0, resume=True, device="cpu")
    assert tr2.run_dir == tr.run_dir and tr2.step == 20
    for (n, a), (_, b) in zip(tr.model.named_parameters(), tr2.model.named_parameters()):
        assert torch.equal(a, b), n
    a_state, b_state = tr.optimizer.adam.state, tr2.optimizer.adam.state
    for p, q in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a_state[p]["exp_avg_sq"], b_state[q]["exp_avg_sq"])
    assert tr2.optimizer.adam.param_groups[0]["lr"] == tr.optimizer.adam.param_groups[0]["lr"]
    tr2.train(log_every=10)  # at max_iters already: saves and returns
    assert tr2.step == 20


def test_load_from_warm_starts_new_experiment(tmp_path, scene):
    exp = _exp(max_total_iters=10)
    tr = _trainer(tmp_path, scene, exp)
    tr.train(log_every=10)
    tr2 = TTrainer(exp, scene, exps_root=str(tmp_path), seed=1, expname_prefix="warm_",
                   load_from="unit", timestamp="20260101-000002", device="cpu")
    assert os.path.basename(tr2.run_dir) == "20260101-000002-warm_unit" and tr2.step == 10
    for (n, a), (_, b) in zip(tr.model.named_parameters(), tr2.model.named_parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(FileNotFoundError):
        TTrainer(exp, scene, exps_root=str(tmp_path), seed=1, load_from="nosuch",
                 timestamp="20260101-000003", device="cpu")


def test_divergence_guard_saves_crash_checkpoint(tmp_path, scene):
    tr = _trainer(tmp_path, scene, _exp(max_total_iters=30), timestamp="20260101-000001")
    real_step = tr.step_fn

    def nan_step(model, batch, **kw):
        metrics = dict(real_step(model, batch, **kw))
        metrics["loss"] = torch.tensor(float("nan"))
        return metrics

    tr.step_fn = nan_step
    with pytest.raises(FloatingPointError):
        tr.train(log_every=10)
    assert os.path.exists(os.path.join(tr.ckpt_dir, "-1.ckpt"))


def test_steps_per_call_runs_and_checkpoints(tmp_path, scene):
    tr = _trainer(tmp_path, scene, _exp(max_total_iters=24, checkpoint_freq=2),
                  steps_per_call=4)
    tr.train(log_every=8)
    assert tr.step == 24
    rows = [json.loads(l) for l in open(os.path.join(tr.run_dir, "metrics.jsonl"))]
    assert [r["iter"] for r in rows] == [4, 8, 16, 24]
    assert sorted(os.listdir(tr.ckpt_dir)) == ["2.ckpt", "4.ckpt", "6.ckpt", "latest.ckpt"]
    # more than one device needs a process group (cli/train.py --n_devices spawns one)
    with pytest.raises(ValueError, match="process group"):
        _trainer(tmp_path, scene, _exp(), n_devices=2)


def test_runs_default_to_exps_under_the_working_directory(tmp_path, scene, monkeypatch):
    """Without --exps_root the run directory is exps/ under the working
    directory (a checkout run from its root keeps its runs inside it)."""
    monkeypatch.chdir(tmp_path)
    tr = TTrainer(_exp(), scene, seed=0, device="cpu", timestamp="t0")
    tr.close()
    assert os.path.realpath(tr.run_dir) == os.path.realpath(tmp_path / "exps" / "t0-unit")
    ap = ttrain.argparse.ArgumentParser()
    ttrain.add_conf_args(ap)
    assert ap.parse_args([]).exps_root == "exps"


def _val_image(scene, frame: int = 1) -> dict:
    H, W = scene["img_res"]
    sl = slice(frame * H * W, (frame + 1) * H * W)
    return {"rays": {k: scene[k][sl] for k in ("rays_o", "rays_d", "depth_scale", "pose")},
            "gt": {k: scene[k][sl] for k in ("rgb", "depth", "normal", "mask")},
            "frame_idx": frame, "img_res": (H, W)}


def test_validation_plot_writes_mesh_and_dashboards(tmp_path, scene):
    """plot_freq 1 epoch (4 iterations): the mesh and the PNG panels of
    each plotted epoch before the last; validate's PSNR and export_mesh."""
    tr = _trainer(tmp_path, scene, _exp(max_total_iters=8, plot_freq=1),
                  val_images=[_val_image(scene)])
    tr.train(log_every=4)
    files = sorted(os.listdir(tr.plot_dir))
    assert "surface_1.ply" in files and "surface_2.ply" not in files
    for name in ("rendering", "depth", "normal", "merge"):
        assert f"VAL_{name}_1_1.png" in files, files
    from monosdf_torch.data.png import read_png

    assert read_png(os.path.join(tr.plot_dir, "VAL_merge_1_1.png")).shape == (8, 48, 3)
    (v,) = tr.validate()
    assert v["frame_idx"] == 1 and np.isfinite(v["psnr"])
    path, verts, faces = tr.export_mesh(resolution=16)
    assert os.path.exists(path) and len(faces) > 0


@pytest.mark.parametrize("if_pixel", [True, False])
def test_sample_batch_is_jax_bit_for_bit(jax_runs, scene, tmp_path, if_pixel):
    tr, conf = jax_runs["mlp"]
    jt = dataclasses.replace(tr.exp, dataset={"if_pixel": if_pixel})
    texp = dataclasses.replace(_exp(), dataset={"if_pixel": if_pixel})
    tt = _trainer(tmp_path, scene, texp)
    saved_exp, saved_rng = tr.exp, tr.rng
    tr.exp, tr.rng = jt, np.random.default_rng(0)
    try:
        for _ in range(3):
            jb, tb = tr.sample_batch(32), tt.sample_batch(32)
            for part in ("rays", "gt"):
                for k in jb[part]:
                    assert np.array_equal(tb[part][k].numpy(), np.asarray(jb[part][k])), k
    finally:
        tr.exp, tr.rng = saved_exp, saved_rng


# -- the CLIs' conf path -----------------------------------------------------

@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from monosdf_torch.scripts import make_synthetic_scene

    root = tmp_path_factory.mktemp("scenes")
    make_synthetic_scene.main([str(root), "--shape", "union", "--n", "3", "--res", "8"])
    return root


DATASET = {"data_dir": "union_scene", "img_res": [8, 8], "use_mask": True, "if_gt_data": True,
           "val_frame_num": 1}


def test_train_cli_conf_runs_and_resumes(tmp_path, scene_dir):
    conf = tmp_path / "unit.conf"
    conf.write_text(hocon({**conf_dict(checkpoint_freq=1, max_total_iters=6),
                           "dataset": DATASET}))
    args = ["--conf", str(conf), "--data_root", str(scene_dir), "--exps_root",
            str(tmp_path / "exps"), "--device", "cpu"]
    tr = ttrain.main(args + ["--timestamp", "t0", "--max_iters", "4"])
    assert tr.step == 4 and os.path.exists(os.path.join(tr.plot_dir, "surface_4.ply"))
    tr2 = ttrain.main(args + ["--resume"])
    assert tr2.run_dir == tr.run_dir and tr2.step == 6
    rows = [json.loads(l) for l in open(os.path.join(tr.run_dir, "metrics.jsonl"))]
    assert [r["iter"] for r in rows] == [1, 5]
    with pytest.raises(SystemExit):
        ttrain.main(args + ["--grids"])


def test_eval_cli_conf_reads_a_jax_checkpoint(jax_runs, tmp_path, scene_dir):
    tr, conf = jax_runs["mlp"]
    path = tmp_path / "unit.conf"
    path.write_text(hocon({**conf, "dataset": DATASET}))
    out = tmp_path / "eval"
    rows = teval.main(["--conf", str(path), "--checkpoint_dir", tr.ckpt_dir, "--data_root",
                       str(scene_dir), "--device", "cpu", "--resolution", "16",
                       "--eval_rendering", "--out_dir", str(out)])
    assert len(rows) == 1 and np.isfinite(rows[0][1])
    assert os.path.exists(out / "surface_16.ply")
    lines = (out / "psnr.csv").read_text().splitlines()
    assert lines[0] == "frame,psnr" and lines[-1].startswith("mean,")

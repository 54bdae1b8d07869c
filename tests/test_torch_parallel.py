"""The port's data parallelism (``monosdf_torch.parallel``: DDP over
``torch.distributed``) against the JAX package's ``monosdf_tpu.parallel``.

One module-scoped group of 2 gloo ranks (``parallel.spawn``, joined within
a deadline) runs the DDP cases below, each rank writing its results to the
group's directory; each case is a test of its own here:
* DDP at world 2 against the port's serial mean of the two per-chunk
  gradients, with the same injected draws, for the MLP and grid models at
  atol 1e-6 (JAX's bar, tests/test_train.py:252);
* DDP at world 2 against ``monosdf_tpu.parallel.make_parallel_train_step``
  on 2 of the 8 CPU devices, from the same weights, 2x8-ray batch and each
  rank's draws from JAX's key tree (``fold_in(key, r)``), the MLP model and
  the union model with codes (``indices`` sharded), at
  tests/test_torch_train.py's step bars;
* the DDP checkpoint round trip, bit for bit (tests/test_train.py:362's
  analog), its payload read by the JAX package's ``restore_state``;
* the Trainer under the group: one run directory, rank 0's metrics log
  with ``rays_per_sec`` over the global batch, each rank's generator;
* ``dryrun_ddp(2, tiny=True)``.
The training CLI at ``--n_devices 2`` on the CPU runs in a process of its
own, started with the group. Host-only cases: ``shard_batch`` and the
Trainer's global draw against JAX's rows, the rank generators, and the
sampler's inverse-sphere background against ``monosdf_tpu.ops.sampler``.

The spawned ranks import this module: it imports neither JAX nor the JAX
package at its top (the parent's references import them where they run).
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from monosdf_torch.losses import LossConfig
from monosdf_torch.models.monosdf import init_monosdf
from monosdf_torch.parallel import ddp
from monosdf_torch.params import load_jax_params
from monosdf_torch.train import OptimConfig, make_optimizer

torch.set_num_threads(2)  # leave the cores to the other test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0  # every spawn is joined within this, then killed
N_RAYS = 8  # a rank's rays; the global batch is 2 x N_RAYS
ITERS = {"max_total_iters": 2}
CODES = dict(white_bkgd=True, rendering=dict(per_image_code=True, code_dim=8, max_images=4))


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    # the Trainer's metrics writer falls back to its JSONL log (importing
    # tensorboard pulls in TensorFlow here: seconds)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# -- the ranks' side (no JAX here) --------------------------------------------

def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.ascontiguousarray(tree)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def _params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _ddp_step(rank, tcfg, tree, batch, draws, grid=False):
    """One DDP step from ``tree`` on this rank's shard of ``batch``: the
    averaged gradients, the parameters after and the metrics."""
    model = load_jax_params(init_monosdf(tcfg, device="cpu"), tree)
    opt = make_optimizer(OptimConfig(grid_mode=grid), model.named_parameters())
    step = ddp.make_parallel_train_step(tcfg, LossConfig(), opt)
    local = _to_torch(ddp.shard_batch(batch, rank, 2))
    metrics = step(ddp.replicate(model), local, draws=_to_torch(draws[rank]))
    return {"grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "params": _params(model), "metrics": {k: float(v) for k, v in metrics.items()}}


def _ckpt_case(rank, store_dir, tcfg, tree, batches):
    """4 steps without a break; 2 steps, rank 0 saves, a fresh group
    restores on both ranks, 2 more steps. Each step's draws from a
    generator of its own (rank, step)."""
    from monosdf_torch.train.checkpoint import load_checkpoint, restore_state, save_checkpoint

    def run(model, opt, steps):
        step = ddp.make_parallel_train_step(tcfg, LossConfig(), opt)
        wrapped = ddp.replicate(model)
        for i in steps:
            local = _to_torch(ddp.shard_batch(batches[i], rank, 2))
            step(wrapped, local, generator=torch.Generator().manual_seed(100 * i + rank))

    def fresh():
        model = load_jax_params(init_monosdf(tcfg, device="cpu"), tree)
        return model, make_optimizer(OptimConfig(), model.named_parameters())

    model, opt = fresh()
    run(model, opt, range(4))
    straight = _params(model)
    model, opt = fresh()
    run(model, opt, range(2))
    saved = _params(model)
    ckpt_dir = os.path.join(store_dir, "ckpt")
    if rank == 0:
        save_checkpoint(ckpt_dir, model, opt, epoch=0)
    ddp.barrier()
    torch.distributed.destroy_process_group()
    ddp.init_group(rank, 2, os.path.join(store_dir, "group2"), "cpu")
    model = init_monosdf(tcfg, seed=5, device="cpu")  # other weights, all restored
    opt = make_optimizer(OptimConfig(), model.named_parameters())
    restore_state(model, opt, load_checkpoint(ckpt_dir))
    run(model, opt, range(2, 4))
    return {"straight": straight, "resumed": _params(model), "saved": saved,
            "ckpt_dir": ckpt_dir}


def _trainer_case(rank, store_dir, exp, scene):
    """The Trainer under the group, 3 steps logged each, on a clock that
    moves 1 s a reading."""
    import monosdf_torch.train.trainer as trainer_mod

    ticks = iter(range(10**6))
    trainer_mod.time = types.SimpleNamespace(perf_counter=lambda: float(next(ticks)))
    tr = trainer_mod.Trainer(exp, scene, exps_root=os.path.join(store_dir, "exps"), seed=0,
                             n_devices=2, device="cpu")
    tr.train(max_iters=3, log_every=1)
    tr.close()
    return {"run_dir": tr.run_dir, "params": _params(tr.model),
            "seed": tr.generator.initial_seed(), "distributed": tr.distributed}


def group_worker(rank, world_size, store_dir, inputs_path):
    """A rank of the module's group: every case in turn, each result
    pickled to ``<store_dir>/<case>_<rank>.pkl``."""
    # one thread: every process sums in one order, so a rank's chunk and the
    # parent's serial emulation of it give the same bits (the sampler turns a
    # last-bit difference into a moved sample)
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # its import pulls in TensorFlow here
    ddp.init_group(rank, world_size, store_dir, "cpu")
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)

    def put(case, result):
        with open(os.path.join(store_dir, f"{case}_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)

    for case, (tcfg, tree, batch, draws) in inputs["steps"].items():
        put(case, _ddp_step(rank, tcfg, tree, batch, draws, grid=case == "serial-grid"))
    exp, scene = inputs["trainer"]
    put("trainer", _trainer_case(rank, store_dir, exp, scene))
    from monosdf_torch.parallel import dryrun_ddp

    put("dryrun", dryrun_ddp(2, tiny=True, device="cpu"))
    put("ckpt", _ckpt_case(rank, store_dir, *inputs["ckpt"]))  # last: it makes a new group


# -- the parent's side ----------------------------------------------------------

def _batch(seed: int, n: int = 2 * N_RAYS) -> dict:
    """n rays, ground truth and frames (``indices``) of 2 frames of the
    synthetic sphere (tests/test_torch_train.py's)."""
    from monosdf_tpu.data.synthetic import make_synthetic_sphere_scene, sample_ray_batch

    b = sample_ray_batch(make_synthetic_sphere_scene(n_images=2, img_res=8),
                         np.random.default_rng(seed), n)
    return {k: b[k] for k in ("rays", "gt", "indices")}


def _setups():
    """case -> (JAX config, port config, JAX params, tree) of the DDP step cases."""
    from torch_parity import both_models, configs, grid_configs

    out = {}
    for case, (build, kw) in {"serial-mlp": (configs, dict(kernels=True)),
                              "serial-grid": (grid_configs, dict(kernels=True)),
                              "jax-mlp": (configs, dict(kernels=False)),
                              "jax-union": (configs, dict(kernels=False, **CODES))}.items():
        jcfg, tcfg = build(sampler=ITERS, **kw)
        out[case] = (jcfg, tcfg, *both_models(jcfg, tcfg)[::2])
    return out


def _key():
    import jax

    return jax.random.PRNGKey(7)


def _rank_draws(case: str, jcfg) -> list:
    """Each rank's draws: JAX's shard r draws from fold_in(key, r)
    (monosdf_tpu/parallel/mesh.py:84); the serial cases from key r."""
    import jax
    from torch_parity import jax_draws

    if case.startswith("jax"):
        return [jax_draws(jax.random.fold_in(_key(), r), N_RAYS, jcfg) for r in range(2)]
    return [jax_draws(jax.random.PRNGKey(r), N_RAYS, jcfg) for r in range(2)]


TINY_CONF = {
    "train": {"expname": "ddp", "learning_rate": 1e-3, "num_pixels": 32, "split_n_pixels": 64,
              "max_total_iters": 4, "checkpoint_freq": 1, "plot_freq": 0},
    "plot": {"resolution": 24},
    "model": {"feature_vector_size": 16, "scene_bounding_sphere": 1.1,
              "implicit_network": {"dims": [32, 32], "multires": 4, "inside_outside": False,
                                   "bias": 0.5},
              "rendering_network": {"dims": [32, 32], "multires_view": 2},
              "ray_sampler": {"N_samples": 8, "N_samples_eval": 16, "N_samples_extra": 4,
                              "max_total_iters": 2, "intersection": "cube"}},
    "dataset": {"data_dir": "union_scene", "img_res": [8, 8], "use_mask": True,
                "if_gt_data": True, "val_frame_num": 1},
}


def _start_cli(root: str) -> subprocess.Popen:
    """cli/train.py --conf at --device cpu --n_devices 2, in a session of its
    own (so the deadline kills its ranks too); tensorboard kept out of the
    ranks' reach by a sitecustomize on their path."""
    from monosdf_torch.scripts import make_synthetic_scene

    make_synthetic_scene.main([os.path.join(root, "scenes"), "--shape", "union", "--n", "3",
                               "--res", "8"])
    conf = os.path.join(root, "ddp.conf")
    with open(conf, "w") as f:
        f.write("".join(f"{k} = {json.dumps(v)}\n" for k, v in TINY_CONF.items()))
    site = os.path.join(root, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write("import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [site, REPO, os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "monosdf_torch.cli.train", "--conf", conf, "--data_root",
           os.path.join(root, "scenes"), "--exps_root", os.path.join(root, "exps"),
           "--timestamp", "t0", "--device", "cpu", "--n_devices", "2", "--max_iters", "4"]
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


class Group:
    """The module's spawned runs: the 2-rank group and the CLI's process."""

    def __init__(self, root: str):
        from monosdf_torch.config import build_configs
        from monosdf_torch.data.synthetic import make_synthetic_sphere_scene

        self.root, self.setups = root, _setups()
        self.batches = {case: _batch(seed=2) for case in self.setups}
        steps = {case: (tcfg, tree, self.batches[case], _rank_draws(case, jcfg))
                 for case, (jcfg, tcfg, _, tree) in self.setups.items()}
        jcfg, tcfg, _, tree = self.setups["jax-mlp"]
        self.ckpt_batches = [_batch(seed=30 + i) for i in range(4)]
        exp = build_configs({k: v for k, v in TINY_CONF.items() if k != "dataset"})
        inputs = {"steps": steps, "ckpt": (tcfg, tree, self.ckpt_batches),
                  "trainer": (exp, make_synthetic_sphere_scene(n_images=2, img_res=8))}
        self.store = os.path.join(root, "group")
        os.makedirs(self.store)
        path = os.path.join(root, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inputs, f)
        self.exp = exp
        self.t0 = time.monotonic()
        self.workers = ddp.spawn(group_worker, 2, (path,), store_dir=self.store, join=False)
        self.cli = _start_cli(os.path.join(root, "cli"))
        self._joined = None

    def results(self, case: str) -> list:
        """Both ranks' results of ``case``, once the group has finished."""
        if self._joined is None:
            try:
                self.workers.join(DEADLINE_S - (time.monotonic() - self.t0))
                self._joined = True
            except Exception as e:
                self._joined = e
        if self._joined is not True:
            pytest.fail(f"the DDP group failed: {self._joined}")
        out = []
        for r in range(2):
            with open(os.path.join(self.store, f"{case}_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    def cli_output(self) -> str:
        try:
            out, _ = self.cli.communicate(timeout=max(1.0, DEADLINE_S -
                                                      (time.monotonic() - self.t0)))
        except subprocess.TimeoutExpired:
            os.killpg(self.cli.pid, signal.SIGKILL)
            self.cli.communicate()
            pytest.fail(f"cli/train.py --n_devices 2 did not finish within {DEADLINE_S:.0f} s")
        assert self.cli.returncode == 0, out
        return out

    def close(self):
        self.workers.kill()
        if self.cli.poll() is None:
            os.killpg(self.cli.pid, signal.SIGKILL)
            self.cli.communicate()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(str(tmp_path_factory.mktemp("ddp")))
    yield g
    g.close()


def _serial_grads(tcfg, tree, batch, draws) -> dict:
    """The port's serial emulation: each rank's chunk alone, gradients averaged."""
    from monosdf_torch.train.step import step_losses

    grads, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' one thread (group_worker)
    try:
        for r in range(2):
            model = load_jax_params(init_monosdf(tcfg, device="cpu"), tree)
            chunk = _to_torch(ddp.shard_batch(batch, r, 2))
            step_losses(model, tcfg, LossConfig(), chunk, 0,
                        _to_torch(draws[r]))["loss"].backward()
            grads.append({n: p.grad.numpy() for n, p in model.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    return {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}


# the JAX parallel step of a case: jnp backends, make_optimizer's Adam, its
# shard_map'd step compiled once (jit_ref) on 2 of the 8 CPU devices
def _jax_parallel(group, case):
    import jax
    import monosdf_tpu.losses as jl
    import monosdf_tpu.parallel as jpar
    import monosdf_tpu.train as jt
    from torch_parity import jit_ref

    jcfg, _, jparams, _ = group.setups[case]
    mesh = jpar.make_mesh(jax.devices()[:2])
    opt = jt.make_optimizer(jt.OptimConfig())
    pstep = jpar.make_parallel_train_step(jcfg, jl.LossConfig(), opt, mesh)
    batch = jpar.shard_batch(jax.tree_util.tree_map(jax.numpy.asarray, group.batches[case]),
                             mesh)
    state, metrics = jit_ref(pstep.__wrapped__)(jt.init_train_state(jparams, opt), batch, _key())
    return state, {k: float(v) for k, v in metrics.items()}


def _flat(tree) -> dict:
    import jax
    from monosdf_torch.params import flatten_tree

    return {k.replace("/", "."): v for k, v in
            flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


# every parameter and metric (the loss terms, beta) at tests/test_torch_train.py's step bars
@pytest.mark.parametrize("case", ["jax-mlp", "jax-union"])
def test_ddp_step_matches_jax_parallel_step(group, case):
    state, mj = _jax_parallel(group, case)
    assert int(state.step) == 1
    pj = _flat(state.params)
    res = group.results(case)
    for n, v in res[0]["params"].items():
        assert np.array_equal(v, res[1]["params"][n]), n  # the same update on both ranks
        np.testing.assert_allclose(v, pj[n], atol=5e-6, rtol=0, err_msg=n)
    assert pj.keys() == res[0]["params"].keys()
    for k in mj:
        np.testing.assert_allclose(res[0]["metrics"][k], mj[k], atol=1e-6,
                                   rtol=1e-4 if k == "depth_loss" else 1e-5, err_msg=k)
    assert res[0]["metrics"] == res[1]["metrics"]
    if case == "jax-union":
        # each rank's frames' code rows move: both shards' indices reached the update
        idx = group.batches[case]["indices"]
        assert len(set(idx[:N_RAYS])) > 1 and len(set(idx[N_RAYS:])) > 1
        assert np.abs(res[0]["grads"]["rendering.embeddings"][np.unique(idx)]).min() > 0


@pytest.mark.parametrize("case", ["serial-mlp", "serial-grid"])
def test_ddp_gradient_is_the_serial_mean(group, case):
    jcfg, tcfg, _, tree = group.setups[case]
    want = _serial_grads(tcfg, tree, group.batches[case], _rank_draws(case, jcfg))
    res = group.results(case)
    assert res[0]["grads"].keys() == want.keys()
    for n in want:
        assert np.abs(want[n]).max() > 0, n  # every parameter takes part
        np.testing.assert_allclose(res[0]["grads"][n], want[n], atol=1e-6, rtol=0, err_msg=n)
        np.testing.assert_array_equal(res[0]["params"][n], res[1]["params"][n], err_msg=n)


def test_ddp_checkpoint_round_trip_is_exact(group):
    import jax
    import monosdf_tpu.train as jt
    import monosdf_tpu.train.checkpoint as jck

    res = group.results("ckpt")
    for r in range(2):
        for n, v in res[r]["straight"].items():
            np.testing.assert_array_equal(res[r]["resumed"][n], v, err_msg=n)
            np.testing.assert_array_equal(v, res[0]["straight"][n], err_msg=n)
    # rank 0's payload, read by the JAX package: the parameters after 2 steps
    jcfg, _, jparams, _ = group.setups["jax-mlp"]
    opt = jt.make_optimizer(jt.OptimConfig())
    payload = jck.load_checkpoint(res[0]["ckpt_dir"])
    state = jck.restore_state(jt.init_train_state(jparams, opt), payload, strict=True)
    assert int(state.step) == 2
    restored = _flat(state.params)
    for n, v in res[0]["saved"].items():
        np.testing.assert_array_equal(restored[n], v, err_msg=n)
    assert jax.tree_util.tree_structure(state.opt_state) == \
        jax.tree_util.tree_structure(opt.init(jparams))


def test_trainer_under_the_group(group):
    res = group.results("trainer")
    assert res[0]["run_dir"] == res[1]["run_dir"] and all(r["distributed"] for r in res)
    assert [r["seed"] for r in res] == [ddp.rank_seed(0, 0), ddp.rank_seed(0, 1)]
    for n, v in res[0]["params"].items():
        np.testing.assert_array_equal(v, res[1]["params"][n], err_msg=n)
    rows = [json.loads(l) for l in open(os.path.join(res[0]["run_dir"], "metrics.jsonl"))]
    assert [r["iter"] for r in rows] == [1, 2, 3]  # one row a log point: rank 0's alone
    # 1 s a log interval on the group's clock: the global batch of 2 x num_pixels rays
    assert {r["rays_per_sec"] for r in rows} == {2.0 * group.exp.num_pixels}
    assert os.listdir(os.path.join(res[0]["run_dir"], "checkpoints")) != []


def test_dryrun_ddp_two_ranks_tiny(group):
    losses = group.results("dryrun")
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_train_cli_two_gloo_workers(group):
    out = group.cli_output()
    exps = os.path.join(group.root, "cli", "exps")
    (run,) = os.listdir(exps)
    run_dir = os.path.join(exps, run)
    rows = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["iter"] for r in rows] == [1]  # written once, by rank 0
    assert "replicas: the 2 ranks hold the same parameters" in out
    assert out.count("mesh: ") == 1
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert "latest.ckpt" in ckpts and len(ckpts) >= 2
    plies = [f for f in os.listdir(os.path.join(run_dir, "plots")) if f.endswith(".ply")]
    assert plies == ["surface_4.ply"]


# -- host only ----------------------------------------------------------------

@pytest.mark.parametrize("if_pixel", [True, False])
def test_shard_batch_and_global_draw_give_jax_rows(if_pixel, tmp_path):
    import jax
    import monosdf_tpu.parallel as jpar
    from monosdf_tpu.train.trainer import Trainer as JTrainer
    from monosdf_torch.config import build_configs
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.train.trainer import Trainer

    scene = make_synthetic_sphere_scene(n_images=2, img_res=8)
    conf = {k: v for k, v in TINY_CONF.items() if k != "dataset"}
    exp = build_configs({**conf, "dataset": {"if_pixel": if_pixel}})
    stub = types.SimpleNamespace(train_rays=scene, exp=types.SimpleNamespace(
        dataset=exp.dataset, model=types.SimpleNamespace(rendering=exp.model.rendering)),
        rng=np.random.default_rng(0))
    mesh = jpar.make_mesh(jax.devices()[:2])
    jglobal = JTrainer.sample_batch(stub, 2 * exp.num_pixels)
    jsharded = jpar.shard_batch(jglobal, mesh)
    for r in range(2):
        tr = Trainer(exp, scene, exps_root=str(tmp_path), seed=0, device="cpu",
                     timestamp=f"r{r}")
        tr.rank, tr.world = r, 2  # the rank's view of a 2-rank group
        tb = tr.sample_batch(2 * exp.num_pixels)
        tr.close()
        for k in ("rays", "gt"):
            for kk, v in tb[k].items():
                (shard,) = [s for s in jsharded[k][kk].addressable_shards if s.device.id == r]
                np.testing.assert_array_equal(v.numpy(), np.asarray(shard.data), err_msg=kk)
                np.testing.assert_array_equal(
                    v.numpy(), ddp.shard_batch(np.asarray(jglobal[k][kk]), r, 2), err_msg=kk)


def test_rank_generators_differ_and_rank0_is_the_single_device_stream(tmp_path):
    from monosdf_torch.config import build_configs
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.train.trainer import Trainer

    draws = [torch.rand(16, generator=ddp.rank_generator(3, r, "cpu")) for r in range(4)]
    assert all(not torch.equal(draws[a], draws[b]) for a in range(4) for b in range(a))
    exp = build_configs({k: v for k, v in TINY_CONF.items() if k != "dataset"})
    tr = Trainer(exp, make_synthetic_sphere_scene(n_images=2, img_res=8), seed=3, device="cpu",
                 exps_root=str(tmp_path))
    tr.close()
    assert not tr.distributed and tr.ddp_model is None
    assert torch.equal(torch.rand(16, generator=tr.generator), draws[0])
    assert torch.equal(draws[0], torch.rand(16, generator=torch.Generator().manual_seed(3)))


def test_shard_batch_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="does not split"):
        ddp.shard_batch({"a": np.zeros(5)}, 0, 2)


# the sampler's inverse-sphere background (tests/test_sampler.py:154-185's
# cases) against monosdf_tpu.ops.sampler at 2e-5
def _bg_cfgs(**kw):
    import monosdf_tpu.ops.sampler as js
    import monosdf_torch.ops.sampler as ts

    kw = {"inverse_sphere_bg": True, **kw}
    return js.SamplerConfig(**kw), ts.SamplerConfig(**kw)


def test_inverse_sphere_bg_z_vals_match_jax():
    import jax
    import jax.numpy as jnp
    import monosdf_tpu.ops.sampler as js
    import monosdf_torch.ops.sampler as ts

    jc, tc = _bg_cfgs(scene_bounding_sphere=2.0, N_samples_inverse_sphere=12)
    rng = np.random.default_rng(0)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    zj = js.inverse_sphere_bg_z_vals(jnp.asarray(o), jnp.asarray(d), jc, None, training=False)
    zt = ts.inverse_sphere_bg_z_vals(torch.from_numpy(o), torch.from_numpy(d), tc, False)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=2e-5, rtol=0)
    # training: JAX's uniforms under its key, injected
    key = jax.random.PRNGKey(4)
    zj = js.inverse_sphere_bg_z_vals(jnp.asarray(o), jnp.asarray(d), jc, key, training=True)
    u = np.array(jax.random.uniform(key, (5, 12), dtype=jnp.float32))
    zt = ts.inverse_sphere_bg_z_vals(torch.from_numpy(o), torch.from_numpy(d), tc, True,
                                     u=torch.from_numpy(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=2e-5, rtol=0)
    zt = ts.inverse_sphere_bg_z_vals(torch.from_numpy(o), torch.from_numpy(d), tc, True,
                                     generator=torch.Generator().manual_seed(0))
    assert zt.shape == (5, 12) and (zt >= 0).all() and (zt <= 0.5 + 1e-6).all()


def test_inverse_sphere_bg_far_is_the_sphere_exit_as_in_jax():
    import jax
    import jax.numpy as jnp
    import monosdf_tpu.ops.sampler as js
    import monosdf_torch.ops.sampler as ts
    from torch_parity import jax_draws, jit_ref, torch_draws

    def sdf_np(p):
        return np.linalg.norm(p, axis=-1) - 0.5

    jc, tc = _bg_cfgs(scene_bounding_sphere=1.1, N_samples=8, N_samples_eval=16,
                      N_samples_extra=4, max_total_iters=2, intersection="sphere")
    o = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (4, 1))
    o[:, 0] = np.linspace(-0.3, 0.3, 4)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    key = jax.random.PRNGKey(0)
    k_sampler = jax.random.split(key, 3)[0]
    zj, ej = jit_ref(lambda o, d, k: js.error_bound_z_vals(
        lambda p: jnp.linalg.norm(p, axis=-1) - 0.5, o, d, jnp.asarray(0.01), jc, k, True))(
        jnp.asarray(o), jnp.asarray(d), k_sampler)
    mcfg = types.SimpleNamespace(sampler=jc, scene_bounding_sphere=1.1)
    draws = torch_draws(jax_draws(key, 4, mcfg))
    zt, et = ts.error_bound_z_vals(lambda p: torch.from_numpy(sdf_np(p.numpy())),
                                   torch.from_numpy(o), torch.from_numpy(d), 0.01, tc, True,
                                   draws)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=2e-5, rtol=0)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=2e-5, rtol=0)
    exit_dist = 2.0 + np.sqrt(1.1**2 - o[:, 0] ** 2)  # |o_z| + the half chord
    assert (zt.numpy().max(-1) <= exit_dist + 1e-4).all()
    assert np.abs(zt.numpy().max(-1) - exit_dist).max() < 1e-5  # the far is a sample

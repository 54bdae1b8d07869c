"""Parity of the port's training slice with the JAX package.

The sampler's training draws, the MonoSDF loss, Adam with its learning-rate
decay and the whole training step (render, loss, gradients, update) of the
port against ``monosdf_tpu``, with the same parameters (carried by the
weight bridge), rays and random draws: the port takes its draws as
injected tensors, computed here with the JAX package's own
``jax.random.split`` tree. With the kernel backends the JAX side runs its
Pallas kernels in interpret mode and the port each kernel's plain version
(CPU tensors). Tolerances are stated at each test; float32 throughout.
The sampler runs 2 of its 5 iterations, as in tests/test_torch_render.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import monosdf_tpu.losses as jl
import monosdf_tpu.models.monosdf as jm
import monosdf_tpu.ops.sampler as js
import monosdf_tpu.train as jt
import monosdf_torch.losses as tl
import monosdf_torch.models.monosdf as tm
import monosdf_torch.ops.sampler as ts
from monosdf_torch.cli import train as ttrain
from monosdf_torch.params import flatten_tree, load_params_npz
from monosdf_torch.train import OptimConfig, make_optimizer, make_train_step
from torch_parity import both_models, configs, jax_draws, jit_ref, ray_batch, torch_draws

torch.set_num_threads(2)  # leave the cores to the other test workers

ITERS = {"max_total_iters": 2}
N_RAYS = 8


def _batch(n=N_RAYS, seed=0):
    """Rays, ground truth and each ray's frame (``indices``) of 2 frames."""
    from monosdf_tpu.data.synthetic import make_synthetic_sphere_scene, sample_ray_batch

    scene = make_synthetic_sphere_scene(n_images=2, img_res=8)
    b = sample_ray_batch(scene, np.random.default_rng(seed), n)
    return {k: b[k] for k in ("rays", "gt", "indices")}


def _to_jax(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


def _to_torch(b):
    out = {k: {kk: torch.from_numpy(np.ascontiguousarray(v)) for kk, v in b[k].items()}
           for k in ("rays", "gt")}
    out["indices"] = torch.from_numpy(b["indices"].astype(np.int64))
    return out


def _grads_np(model) -> dict:
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def _flat_jax(tree) -> dict:
    return {k.replace("/", "."): v for k, v in
            flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


# the step test's cases: the kernel and plain backends, and the per-image
# code model (codes of 8 for up to 4 frames, white background) with its radiance
# through K3 ('fused', on the kernel backends, as the union model
# cli/eval.py union_codes_config at this test's size) and through K8a
# ('pallas', on the plain sampler and SDF path: K8a does not depend on K2)
CASES = {
    "pallas": dict(kernels=True),
    "jnp": dict(kernels=False),
    "codes-fused": dict(kernels=True, white_bkgd=True,
                        rendering=dict(per_image_code=True, code_dim=8, max_images=4)),
    "codes-pallas": dict(kernels=False, white_bkgd=True, rgb_backend="pallas",
                         rendering=dict(per_image_code=True, code_dim=8, max_images=4)),
}


@functools.lru_cache(maxsize=None)
def _setup(case: str):
    """(JAX config, port config, JAX params, parameter tree) of a case of CASES."""
    kw = dict(CASES[case])
    jcfg, tcfg = configs(kw.pop("kernels"), sampler=ITERS, **kw)
    jparams, _, tree = both_models(jcfg, tcfg)
    return jcfg, tcfg, jparams, tree


def _model(tcfg, tree):
    from monosdf_torch.params import load_jax_params

    return load_jax_params(tm.init_monosdf(tcfg, device="cpu"), tree)


# -- the sampler's training draws ---------------------------------------------

# The jnp backends here; the kernel backends' sampler (JAX Pallas K1/K4 in
# interpret mode) runs inside test_training_step_matches_jax[pallas], whose
# loss it would move. z_vals behind the surface can move by (float32
# rounding of the cdf) / pdf where the pdf is ~add_tiny
# (tests/test_torch_render.py); z_eik is one of them.
def test_sampler_training_mode_with_jax_draws():
    jcfg, tcfg, jparams, tree = _setup("jnp")
    model = _model(tcfg, tree)
    rays = ray_batch(N_RAYS, seed=1)
    key = jax.random.PRNGKey(3)
    d = jax_draws(key, N_RAYS, jcfg)
    k_sampler_key = jax.random.split(key, 3)[0]

    def jsample(p, r):
        beta0 = jnp.abs(p["density"]["beta"]) + jcfg.beta_min
        return js.error_bound_z_vals(
            lambda pts: jm.sdf_value(p["implicit"], jcfg.implicit, pts)[..., 0],
            r["rays_o"], r["rays_d"], beta0, jcfg.sampler, k_sampler_key, True)

    zj, ej = jit_ref(jsample)(jparams, {k: jnp.asarray(v) for k, v in rays.items()})
    rt = {k: torch.from_numpy(v) for k, v in rays.items()}
    beta0 = torch.abs(model.density.beta.detach()) + tcfg.beta_min
    zt, et = ts.error_bound_z_vals(
        lambda pts: tm.sdf_value(model.implicit, tcfg.implicit, pts)[..., 0],
        rt["rays_o"], rt["rays_d"], beta0, tcfg.sampler, True, torch_draws(d))
    assert zt.shape == zj.shape and et.shape == (N_RAYS, 1)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-3)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-3)
    assert np.mean(np.abs(zt.numpy() - np.asarray(zj)) < 1e-5) > 0.97


def test_training_draws_come_from_the_generator_when_not_given():
    _, tcfg, _, _ = _setup("pallas")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = ts.training_draws(4, tcfg.sampler, generator=g1)
    b = ts.training_draws(4, tcfg.sampler, {"u_final": a["u_final"] + 1}, generator=g2)
    assert a.keys() == b.keys() == {"t_rand", "u_final", "extra_idx", "eik_idx"}
    assert torch.equal(a["t_rand"], b["t_rand"]) and not torch.equal(a["u_final"], b["u_final"])
    sc = tcfg.sampler
    assert a["extra_idx"].unique().numel() == sc.N_samples_extra
    assert int(a["eik_idx"].max()) < sc.total_samples


# -- the loss ---------------------------------------------------------------

def _loss_inputs(seed=0, R=16, S=12):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    sdf = f(R, S)
    sdf[:3] = np.abs(sdf[:3])  # rays that do not cross the surface
    outs = {"rgb_values": rng.uniform(0, 1, (R, 3)).astype(np.float32),
            "depth_values": rng.uniform(0.5, 2, (R, 1)).astype(np.float32),
            "normal_map": f(R, 3), "sdf": sdf, "grad_theta": f(2 * R, 3),
            "grad_theta_nei": f(2 * R, 3)}
    outs["normal_map"][5] = 0.0  # a zero normal: the guarded norms
    gt = {"rgb": rng.uniform(0, 1, (R, 3)).astype(np.float32),
          "depth": rng.uniform(0, 1, (R, 1)).astype(np.float32),
          "normal": f(R, 3), "mask": (rng.uniform(size=(R, 1)) > 0.2).astype(np.float32)}
    return outs, gt


# float32 values and gradients of the same formulas, sums in another order
@pytest.mark.parametrize("cfg_kw,step", [({}, 0), ({"rgb_loss": "mse", "if_gamma_loss": True,
                                                   "end_step": 100}, 30),
                                         ({"if_scale_invariant_depth": False}, 0)])
def test_monosdf_loss_value_and_gradients(cfg_kw, step):
    outs, gt = _loss_inputs()
    diff = ("rgb_values", "depth_values", "normal_map", "grad_theta", "grad_theta_nei")

    def jfun(o):
        return jl.monosdf_loss(jl.LossConfig(**cfg_kw), {**outs, **o}, gt, step)

    jo = {k: jnp.asarray(outs[k]) for k in diff}
    jv = jit_ref(jfun)(jo)
    jg = jit_ref(jax.grad(lambda o: jfun(o)["loss"]))(jo)
    to = {k: torch.from_numpy(v).requires_grad_(k in diff) for k, v in outs.items()}
    tv = tl.monosdf_loss(tl.LossConfig(**cfg_kw), to, {k: torch.from_numpy(v) for k, v in
                                                       gt.items()}, step)
    tv["loss"].backward()
    for k in jv:
        np.testing.assert_allclose(tv[k].item(), float(jv[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for k in diff:
        np.testing.assert_allclose(to[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# -- Adam and its schedule --------------------------------------------------

def test_adam_and_lr_schedule_match_optax_over_three_steps():
    """The same gradients three times into both optimizers; decay_steps 2 so
    the learning rate falls visibly. float32: the bias corrections are taken
    in another order (eps outside the square root in both)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 4)).astype(np.float32), "b": rng.normal(size=7).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10 ** (i - 1) for k, v in p0.items()}
             for i in range(3)]
    ocfg = dict(learning_rate=1e-2, decay_steps=2)
    jopt = jt.make_optimizer(jt.OptimConfig(**ocfg))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = jopt.init(jp)
    jupdate = jit_ref(jopt.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    adam, sched = make_optimizer(OptimConfig(**ocfg), tp.items())
    for g in grads:
        upd, state = jupdate(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        adam.step()
        sched.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert sched.get_last_lr()[0] == pytest.approx(1e-2 * 0.25 ** 1.5, rel=1e-6)
    # grid mode groups the parameters by name: no name here is the table's,
    # so one group at lr (tests/test_torch_grid.py holds the three groups'
    # updates against the JAX package's)
    adam, _ = make_optimizer(OptimConfig(grid_mode=True, **ocfg), tp.items())
    assert [g["lr"] for g in adam.param_groups] == [1e-2]


# -- the training step ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(case):
    """make_train_step's loss_fn (monosdf_tpu/train/step.py:42-53) under
    jax.value_and_grad, jitted once for the tests that use it; the step
    count, which the loss reads, is an argument."""
    jcfg = _setup(case)[0]

    def loss_fn(params, batch, key, step):
        image_code = None
        if jcfg.rendering.per_image_code:
            image_code = params["rendering"]["embeddings"][batch["indices"]]
        out = jm.render_rays(params, jcfg, batch["rays"], key, training=True,
                             image_code=image_code)
        losses = jl.monosdf_loss(jl.LossConfig(), out, batch["gt"], step)
        mse = jnp.mean((out["rgb_values"] - batch["gt"]["rgb"]) ** 2)
        losses["psnr"] = -10.0 * jnp.log(mse) / jnp.log(10.0)
        return losses["loss"], losses

    return jit_ref(jax.value_and_grad(loss_fn, has_aux=True))


# the JAX optimizer of the step tests, its update and apply jitted once
JOPT = jt.make_optimizer(jt.OptimConfig())
_jinit, _jupdate, _japply = jit_ref(JOPT.init), jit_ref(JOPT.update), jit_ref(optax.apply_updates)


def _jax_steps(case, jparams, batches, keys):
    """The JAX training step (make_train_step's train_step,
    monosdf_tpu/train/step.py:55-62: loss_fn under value_and_grad, then the
    optimizer's update, applied) once per batch, on the jitted
    value_and_grad the step test compiles: the parameters after each step,
    and each step's metrics."""
    vg = _jax_value_and_grad(case)
    params, opt_state, after, metrics = jparams, _jinit(jparams), [], []
    for i, (b, k) in enumerate(zip(batches, keys)):
        (_, m), grads = vg(params, _to_jax(b), k, jnp.int32(i))
        updates, opt_state = _jupdate(grads, opt_state, params)
        params = _japply(params, updates)
        after.append(params)
        metrics.append({kk: float(v) for kk, v in m.items()})
    return after, metrics


# Loss and its terms (rtol 1e-5; the depth term 1e-4: its scale/shift solve
# over the batch's 8 rays amplifies the rendered depths' float32 rounding),
# every parameter gradient (at tests/test_pallas_sdf_grad.py:224-226's bar,
# 5e-4 / 2e-3: the render's gradient sums over samples and rays) and the
# parameters after one Adam step, within 1% of its lr 5e-4 (the first Adam
# step moves a parameter by lr g / (|g| + 1e-8): gradients that agree to
# float32 rounding give the same move unless |g| is near 1e-8).
# The code cases also hold the gradient of every embeddings row (only the
# batch's frames' rows are nonzero) and the white background.
@pytest.mark.parametrize("case", list(CASES))
def test_training_step_matches_jax(case):
    jcfg, tcfg, jparams, tree = _setup(case)
    batch = _batch(seed=2)
    key = jax.random.PRNGKey(7)
    (_, mj), gj = _jax_value_and_grad(case)(jparams, _to_jax(batch), key, jnp.int32(0))
    upd, _ = _jupdate(gj, _jinit(jparams), jparams)
    pj = _flat_jax(_japply(jparams, upd))

    draws = torch_draws(jax_draws(key, N_RAYS, jcfg))
    tb = _to_torch(batch)
    model = _model(tcfg, tree)
    code = model.rendering.embeddings[tb["indices"]] if tcfg.rendering.per_image_code else None
    out = tm.render_rays(model, tcfg, tb["rays"], training=True, image_code=code, draws=draws)
    assert out["grad_theta"].shape == out["grad_theta_nei"].shape == (2 * N_RAYS, 3)
    tl.monosdf_loss(tl.LossConfig(), out, tb["gt"], 0)["loss"].backward()
    grads, gjf = _grads_np(model), _flat_jax(gj)
    assert grads.keys() == gjf.keys()
    if tcfg.rendering.per_image_code:
        seen = np.unique(batch["indices"])
        assert len(seen) > 1 and np.abs(grads["rendering.embeddings"][seen]).max() > 0
    for k in grads:
        np.testing.assert_allclose(grads[k], gjf[k], atol=5e-4, rtol=2e-3, err_msg=k)

    model = _model(tcfg, tree)
    step = make_train_step(tcfg, tl.LossConfig(), make_optimizer(OptimConfig(),
                                                                  model.named_parameters()))
    mt = step(model, tb, draws=draws)
    for k in ("loss", "rgb_loss", "eikonal_loss", "smooth_loss", "normal_l1", "normal_cos",
              "psnr", "depth_loss"):
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), atol=1e-6,
                                   rtol=1e-4 if k == "depth_loss" else 1e-5, err_msg=k)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), pj[n], atol=5e-6, rtol=0, err_msg=n)


def test_three_step_loss_trajectory_matches_jax():
    """Three steps of the JAX training step and of the port's on distinct
    batches and draws, kernel backends (the JAX step checked against
    jt.make_train_step first): the losses follow JAX's at 1e-4
    (each step starts from parameters that agree to float32 rounding of the
    update), and so do the parameters after them."""
    jcfg, tcfg, jparams, tree = _setup("pallas")
    batches = [_batch(seed=10 + i) for i in range(3)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    jp_after, mj = _jax_steps("pallas", jparams, batches, keys)
    # the reference is a copy of make_train_step's body: its first step is
    # jt.make_train_step's own at this shape (loss to 1e-6, parameters to
    # 1e-7 of the lr-sized move: the two programs fuse differently)
    state, m0 = jit_ref(jt.make_train_step(jcfg, jl.LossConfig(), JOPT))(
        jt.init_train_state(jparams, JOPT), _to_jax(batches[0]), keys[0])
    assert int(state.step) == 1
    np.testing.assert_allclose(float(m0["loss"]), mj[0]["loss"], rtol=1e-6)
    p_ref, p_copy = _flat_jax(state.params), _flat_jax(jp_after[0])
    assert p_ref.keys() == p_copy.keys()
    for n in p_ref:
        np.testing.assert_allclose(p_copy[n], p_ref[n], atol=1e-7, rtol=0, err_msg=n)
    model = _model(tcfg, tree)
    step = make_train_step(tcfg, tl.LossConfig(), make_optimizer(OptimConfig(),
                                                                  model.named_parameters()))
    lt = [float(step(model, _to_torch(b), draws=torch_draws(jax_draws(k, N_RAYS, jcfg)))["loss"])
          for b, k in zip(batches, keys)]
    np.testing.assert_allclose(lt, [m["loss"] for m in mj], rtol=1e-4)
    assert len(set(lt)) == 3
    # and the parameters after the three steps, within 10% of the lr 5e-4:
    # each step moves a parameter by about lr, and an element whose gradient
    # is near Adam's eps takes a different share of that move from float32
    # differences in its gradient (measured 1.5e-5); a wrong step would be
    # off by up to 2 lr
    pj = _flat_jax(jp_after[-1])
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), pj[n], atol=5e-5, rtol=0, err_msg=n)


def test_train_cli_writes_npz(tmp_path):
    out = tmp_path / "p.npz"
    hist = ttrain.main(["--device", "cpu", "--steps", "2", "--rays", "4", "--n_images", "1",
                        "--img_res", "4", "--compute_dtype", "float32", "--out", str(out)])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    tree = load_params_npz(out)
    model = tm.init_monosdf(ttrain.bench_config(False, "float32"), device="cpu")
    assert set(flatten_tree(tree)) == {n.replace(".", "/") for n, _ in model.named_parameters()}

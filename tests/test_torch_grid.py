"""Parity of the port's hash-grid model with the JAX package.

The encode (K6's plain version: features and their spatial tangents) and
its table gradient (K5's plain version) against ``monosdf_tpu``
``hash_encode`` under ``jax.linearize`` and ``jax.vjp``, for both hash
schemes, both table dtypes, a flat and a 2-D table, with the JAX package's
Pallas fold and build in interpret mode (K7's plain versions are held
against ``sdf_mlp_with_grad_in`` in tests/test_torch_kernels.py); the grid
render and the grid training step (loss, every gradient with the table's,
the parameters after the grid-mode Adam step) against ``render_rays`` and
``make_train_step``'s loss, with the kernel backends (the port's plain
versions against the JAX package's Pallas kernels) and, for the render, the
plain ones. A tiny grid
(4 levels, 2^12-row hashed levels) and a 2x32 trunk; inputs from numpy with
a seed. float32 at the repo's 2e-5 component bar unless a test states
another tolerance; bf16 cases state theirs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.losses as jl
import monosdf_tpu.models.monosdf as jm
import monosdf_tpu.ops.hashgrid as jh
import monosdf_tpu.train as jt
import monosdf_torch.losses as tl
import monosdf_torch.models.monosdf as tm
import monosdf_torch.ops.hashgrid as th
from monosdf_torch.cli import eval as teval
from monosdf_torch.cli import train as ttrain
from monosdf_torch.kernels import build
from monosdf_torch.kernels.hash_encode import encode_diff, hash_encode_bwd, hash_encode_fwd
from monosdf_torch.params import flatten_tree, load_jax_params, load_params_npz, params_to_tree
from monosdf_torch.params import save_params_npz
from monosdf_torch.train import OptimConfig, make_optimizer, make_train_step
from torch_parity import (
    GRID,
    both_models,
    grid_configs,
    jax_draws,
    jit_ref,
    ray_batch,
    torch_draws,
)

torch.set_num_threads(2)  # leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)
ITERS = {"max_total_iters": 2}


def _rng(seed):
    return np.random.default_rng(seed)


def _points(n, seed, lo=-1.15, hi=1.15):
    """Points in [lo, hi]^3: with the default range some lie outside the
    encode's [-1, 1]^3 box."""
    return _rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


# -- the encode and its table gradient ------------------------------------------

ENCODE_CASES = {
    # the bench's scheme and layout: 'add', quad table, Pallas build and fold
    "add-quad-pallas-f32-flat": dict(),
    "add-quad-xla-bf16-flat": dict(table_dtype="bfloat16", fold_impl="xla", build_impl="xla"),
    "add-quad-xla-f32-2d": dict(fold_impl="xla", build_impl="xla", param_flat=False),
    # the reference's xor hash over per-corner rows
    "xor-rows-f32-2d": dict(hash_scheme="xor", layout="rows", scatter_impl="flat",
                            fold_impl="xla", build_impl="xla", param_flat=False),
    "xor-rows-bf16-flat": dict(hash_scheme="xor", layout="rows", scatter_impl="flat",
                               fold_impl="xla", build_impl="xla", table_dtype="bfloat16"),
}


def _grid_cfgs(**kw):
    g = {**GRID, **kw}
    return jh.HashGridConfig(**g), th.HashGridConfig(**g)


@functools.lru_cache(maxsize=None)
def _jax_encode_vjp(case):
    """jit of (features, tangents, table gradient) of the JAX encode: the
    tangents by jax.linearize, the table gradient by jax.vjp of both."""
    jcfg, _ = _grid_cfgs(**ENCODE_CASES[case])

    def feat_tg(emb, x):
        out, jvp = jax.linearize(lambda y: jh.hash_encode({"embeddings": emb}, jcfg, y), x)
        return out, jnp.stack([jvp(jnp.broadcast_to(e, x.shape)) for e in jnp.eye(3)])

    def fn(emb, x, cf, ct):
        (f, t), vjp = jax.vjp(lambda e: feat_tg(e, x), emb)
        return f, t, vjp((cf, ct))[0]

    return jit_ref(fn)


def _encode_inputs(case, n=97, seed=0):
    _, tcfg = _grid_cfgs(**ENCODE_CASES[case])
    rng = _rng(seed)
    shape = (tcfg.table_size * 2,) if tcfg.param_flat else (tcfg.table_size, 2)
    emb = rng.uniform(-1, 1, shape).astype(np.float32)
    x = _points(n, seed + 1)
    cf = rng.normal(size=(n, tcfg.output_dim)).astype(np.float32)
    ct = rng.normal(size=(3, n, tcfg.output_dim)).astype(np.float32)
    return tcfg, emb, x, cf, ct


def _port_table(tcfg, emb):
    grid = th.HashGrid(tcfg)
    with torch.no_grad():
        grid.embeddings.copy_(torch.from_numpy(emb))
    return grid, th.read_table(grid, tcfg)


# Features at 2e-5; tangents (up to ~50: 6 v(1-v) fscale / 2 times values of
# 1) at 2e-5 of their largest entry, float32 sums in another order. The table
# gradient: float32 at 2e-4 / 1e-3 (sums over the corners that share a row).
# bf16 tables: the corner values are the same bf16 numbers in both, so the
# features and tangents keep the float32 bar; each corner's cotangent term is
# rounded to bf16, and float32 differences in a term can round it to the
# neighbouring bf16 value (2^-8 relative), and the rows layout rounds each
# row's sum to bf16 as well: 1e-2 of the largest entry bounds that.
@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_features_tangents_and_table_gradient_match_jax(case):
    tcfg, emb, x, cf, ct = _encode_inputs(case)
    jf_, jt_, jg = _jax_encode_vjp(case)(jnp.asarray(emb), jnp.asarray(x), jnp.asarray(cf),
                                         jnp.asarray(ct))
    grid, table = _port_table(tcfg, emb)
    xt = torch.from_numpy(x)
    before = dict(build.launches)
    feat, tg = hash_encode_fwd(table, tcfg, xt, tangents=True)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf_), **TOL)
    scale = float(np.abs(np.asarray(jt_)).max())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jt_), rtol=0, atol=2e-5 * scale)
    oob = np.abs(x).max(-1) > 1.0
    assert oob.any() and (~oob).any()
    assert not feat[torch.from_numpy(oob)].any() and not tg[:, torch.from_numpy(oob)].any()

    d = hash_encode_bwd(tcfg, xt, torch.from_numpy(cf), torch.from_numpy(ct))
    jg = np.asarray(jg).reshape(-1)
    if tcfg.table_dtype == "float32":
        np.testing.assert_allclose(d.numpy(), jg, atol=2e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(d.numpy(), jg, rtol=0, atol=1e-2 * np.abs(jg).max())
    assert np.abs(jg).max() > 1.0  # the tangents' path reaches the table
    # the plain path (autograd through the encode) gives the same gradient
    pf, pt = th.hash_encode(grid, tcfg, xt, tangents=True)
    (g_plain,) = torch.autograd.grad((pf * torch.from_numpy(cf)).sum()
                                     + (pt * torch.from_numpy(ct)).sum(), grid.embeddings)
    np.testing.assert_allclose(g_plain.reshape(-1).numpy(), d.numpy(), atol=2e-5, rtol=2e-5)
    assert build.launches == before  # CPU tensors: the plain versions


def test_autograd_function_reads_the_table_copy_and_grads_the_parameter():
    """encode_diff: K6 forward from the read table, K5 backward into the
    float32 parameter, shaped like it (flat and 2-D)."""
    for flat in (True, False):
        _, tcfg = _grid_cfgs(param_flat=flat, table_dtype="bfloat16")
        grid = th.init_hashgrid(tcfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            grid.embeddings.mul_(1e4)
        table = th.read_table(grid, tcfg)
        assert table.dtype == torch.bfloat16 and table.shape == (tcfg.table_size * 2,)
        x = torch.from_numpy(_points(40, 3))
        cf, ct = torch.randn(40, 8), torch.randn(3, 40, 8)
        feat, tg = encode_diff(grid.embeddings, table, tcfg, x, 1.0, 0.5)
        ((feat * cf).sum() + (tg * ct).sum()).backward()
        assert grid.embeddings.grad.shape == grid.embeddings.shape
        want = hash_encode_bwd(tcfg, x, cf, ct, 1.0, 0.5)
        assert torch.equal(grid.embeddings.grad.reshape(-1), want)
        f2, t2 = hash_encode_fwd(table, tcfg, x, tangents=True)
        assert torch.equal(feat, f2) and torch.allclose(tg, 0.5 * t2, rtol=1e-6, atol=0)


def test_level_truncation_is_the_prefix_of_the_full_encode():
    """n_levels=K: the first K levels at the full schedule's geometry, zeros
    after them (the sweeps'; the grid render below holds them against the
    JAX package's truncated sweep schedule)."""
    _, tcfg = _grid_cfgs()
    emb = _rng(4).uniform(-1, 1, (tcfg.table_size * 2,)).astype(np.float32)
    grid, table = _port_table(tcfg, emb)
    x = torch.from_numpy(_points(64, 5))
    full = hash_encode_fwd(table, tcfg, x)
    for K in (1, 2, 4, 6):
        part = hash_encode_fwd(table, tcfg, x, n_levels=K)
        K = min(K, tcfg.num_levels)
        assert torch.equal(part[:, :2 * K], full[:, :2 * K]) and not part[:, 2 * K:].any()
        assert torch.equal(th.hash_encode(grid, tcfg, x, n_levels=K), part)


# -- the grid render and training step ------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(kernels: bool):
    jcfg, tcfg = grid_configs(kernels, sampler=ITERS)
    jparams, model, tree = both_models(jcfg, tcfg)
    return jcfg, tcfg, jparams, model, tree


OUT_KEYS = ("rgb_values", "depth_values", "normal_map")
SAMPLE_KEYS = ("z_vals", "weights", "sdf")


# Rendered outputs at 1e-4 (float32 sums in another order through the
# sampler, as tests/test_torch_render.py); samples at 1e-3 (a sample drawn
# where the pdf is ~add_tiny moves by the cdf's rounding over the pdf).
@pytest.mark.parametrize("kernels", [True, False], ids=["pallas", "jnp"])
def test_grid_render_matches_jax(kernels):
    jcfg, tcfg, jparams, model, _ = _setup(kernels)
    rays = ray_batch(8, seed=1)
    jout = jit_ref(lambda r: jm.render_rays(jparams, jcfg, r, jax.random.PRNGKey(0),
                                            training=False))(
        {k: jnp.asarray(v) for k, v in rays.items()})
    tout = tm.render_rays(model, tcfg, {k: torch.from_numpy(v) for k, v in rays.items()})
    for k in OUT_KEYS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    for k in SAMPLE_KEYS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-3, err_msg=k)


def _batch(seed):
    from monosdf_tpu.data.synthetic import make_synthetic_sphere_scene, sample_ray_batch

    b = sample_ray_batch(make_synthetic_sphere_scene(n_images=2, img_res=8), _rng(seed), 8)
    return {k: b[k] for k in ("rays", "gt")}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    """make_train_step's loss_fn (monosdf_tpu/train/step.py:42-53) of the
    kernel-backend grid config under jax.value_and_grad, jitted once. Its
    sampler runs the jnp sweeps and machinery, which compute K1's and K4's
    values (tests/test_torch_kernels.py and the render above hold the
    port's against the JAX kernels) and compile in a third less time."""
    jcfg = _setup(True)[0]
    jcfg = dataclasses.replace(jcfg, sampler_backend="jnp",
                               sampler=dataclasses.replace(jcfg.sampler, machinery="jnp"))

    def loss_fn(params, batch, key):
        out = jm.render_rays(params, jcfg, batch["rays"], key, training=True)
        losses = jl.monosdf_loss(jl.LossConfig(), out, batch["gt"], 0)
        return losses["loss"], losses

    return jit_ref(jax.value_and_grad(loss_fn, has_aux=True))


def _torch_batch(batch):
    return {k: {kk: torch.from_numpy(np.ascontiguousarray(v)) for kk, v in batch[k].items()}
            for k in ("rays", "gt")}


# Kernel backends (the JAX package's Pallas kernels K5, K6 and K7 in
# interpret mode against the port's plain versions). Loss at 1e-5 (the
# depth term 1e-4, as tests/test_torch_train.py); every gradient, the
# table's included, at 5e-4 / 2e-3 (the render sums over samples and rays;
# the bar of tests/test_torch_train.py). After one step of the grid-mode
# Adam a parameter has moved by -lr g / (|g| + 1e-15) (the first step's
# bias-corrected moments are g and g^2), lr 5e-4 and the table's 1e-2:
# where |g| is above float32 rounding the moves agree to 1% of lr; an entry
# whose gradient is rounding noise around 0 (|g| < 1e-6 of the tensor's
# largest) may move by up to lr either way, and is held to 2 lr.
def test_grid_training_step_matches_jax():
    jcfg, tcfg, jparams, _, tree = _setup(True)
    batch = _batch(2)
    key = jax.random.PRNGKey(7)
    (_, mj), gj = _jax_value_and_grad()(jparams, jax.tree_util.tree_map(jnp.asarray, batch), key)
    flat = lambda tr: {k.replace("/", "."): v for k, v in
                       flatten_tree(jax.tree_util.tree_map(np.asarray, tr)).items()}
    gjf, p0 = flat(gj), flat(jparams)

    model = load_jax_params(tm.init_monosdf(tcfg, device="cpu"), tree)
    step = make_train_step(tcfg, tl.LossConfig(),
                           make_optimizer(OptimConfig(grid_mode=True), model.named_parameters()))
    before = dict(build.launches)
    mt = step(model, _torch_batch(batch), draws=torch_draws(jax_draws(key, 8, jcfg)))
    assert build.launches == before
    for k in ("loss", "rgb_loss", "eikonal_loss", "normal_l1", "normal_cos", "depth_loss"):
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), atol=1e-6,
                                   rtol=1e-4 if k == "depth_loss" else 1e-5, err_msg=k)
    for n, p in model.named_parameters():
        g = gjf[n]
        np.testing.assert_allclose(p.grad.numpy(), g, atol=5e-4, rtol=2e-3, err_msg=n)
        lr = 5e-4 * (20.0 if "encoding" in n else 1.0)
        moved = np.abs(p.detach().numpy() - (p0[n] - lr * g / (np.abs(g) + 1e-15)))
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        assert moved[live].max(initial=0.0) <= 1e-2 * lr, n
        assert moved.max() <= 2 * lr, n
    assert np.abs(gjf["implicit.encoding.embeddings"]).max() > 1e-3  # the table is trained


def test_grid_plain_path_step_matches_the_kernel_path():
    """The plain path (autograd's double backward through the plain encode
    and trunk) against the kernel path's plain versions (K6/K5 and K7's
    explicit tangents and transposes) at the same samples and eikonal
    points: loss and every gradient, the table's included, float32 at 2e-5
    relative to each tensor's largest entry (the same function, summed in
    another order)."""
    from monosdf_torch.models.monosdf import render_samples, sample_rays

    _, tcfg_k, _, _, tree = _setup(True)
    tcfg_p = dataclasses.replace(tcfg_k, diff_backend="jnp")
    tb = _torch_batch(_batch(3))
    model = load_jax_params(tm.init_monosdf(tcfg_k, device="cpu"), tree)
    z, eik = sample_rays(model, tcfg_k, tb["rays"], True,
                         generator=torch.Generator().manual_seed(0))
    res = []
    for cfg in (tcfg_k, tcfg_p):
        model.zero_grad(set_to_none=True)
        out = render_samples(model, cfg, tb["rays"], z, eik_points=eik)
        loss = tl.monosdf_loss(tl.LossConfig(), out, tb["gt"])["loss"]
        loss.backward()
        res.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (lk, gk), (lp, gp) = res
    assert lk == pytest.approx(lp, rel=1e-6)
    for n in gk:
        scale = float(gp[n].abs().max())
        assert float((gk[n] - gp[n]).abs().max()) <= 2e-5 * scale + 1e-9, n
    assert float(gk["implicit.encoding.embeddings"].abs().max()) > 1e-3


def test_grid_adam_groups_match_optax_flat_adam():
    """Three steps of the grid-mode Adam (encoding at 20x lr, betas (0.9,
    0.99), eps 1e-15, decay) against the JAX package's flat_adam with its
    per-leaf lr scale."""
    rng = _rng(0)
    p0 = {"implicit": {"encoding": {"embeddings": rng.normal(size=12).astype(np.float32)},
                       "lin0": {"b": rng.normal(size=5).astype(np.float32)}},
          "density": {"beta": np.asarray(0.1, np.float32)}}
    ocfg = dict(learning_rate=1e-2, decay_steps=2)
    jopt = jt.make_optimizer(jt.OptimConfig(grid_mode=True, **ocfg))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = jit_ref(jopt.init)(jp)
    jupdate = jit_ref(jopt.update)
    jadd = jit_ref(lambda p, u: jax.tree_util.tree_map(lambda a, b: a + b, p, u))
    named = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(np.copy(v)))
             for k, v in flatten_tree(p0).items()}
    adam, sched = make_optimizer(OptimConfig(grid_mode=True, **ocfg), named.items())
    assert sorted(g["lr"] for g in adam.param_groups) == pytest.approx([1e-2, 1e-2, 0.2])
    for i in range(3):
        g = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 10.0 ** (i - 1))
                                   .astype(np.float32), p0)
        upd, state = jupdate(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jadd(jp, upd)
        for k, v in flatten_tree(g).items():
            named[k.replace("/", ".")].grad = torch.from_numpy(np.asarray(v))
        adam.step()
        sched.step()
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, jp)).items():
            # float32: the bias corrections in another order, carried by
            # the table's 0.2 learning rate into ~1e-6 after three steps
            np.testing.assert_allclose(named[k.replace("/", ".")].detach().numpy(), v,
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_param_bridge_carries_the_table_flat_and_2d(tmp_path):
    """implicit.encoding.embeddings goes tree -> port -> .npz -> port, flat
    and (T, 2), unchanged (the JAX package's own init_monosdf pytree in
    tests/test_torch_ops.py takes the same path)."""
    for flat in (True, False):
        jcfg, tcfg = grid_configs(True, grid={"param_flat": flat})
        tree = both_models(jcfg, tcfg)[2]
        model = load_jax_params(tm.init_monosdf(tcfg, device="cpu"), tree)
        emb = model.implicit.encoding.embeddings
        assert emb.shape == tree["implicit"]["encoding"]["embeddings"].shape
        assert emb.dim() == (1 if flat else 2) and emb.numel() == tcfg.implicit.grid.table_size * 2
        save_params_npz(tmp_path / "p.npz", params_to_tree(model))
        back = load_params_npz(tmp_path / "p.npz")
        np.testing.assert_array_equal(back["implicit"]["encoding"]["embeddings"],
                                      tree["implicit"]["encoding"]["embeddings"])
        model2 = load_jax_params(tm.init_monosdf(tcfg, device="cpu"), back)
        assert torch.equal(model2.implicit.encoding.embeddings, emb)


def test_grids_clis_run_on_the_cpu(tmp_path):
    """cli/train.py --grids: two steps of the full-width grid model at a
    tiny image size; cli/eval.py --grids renders one view."""
    out = tmp_path / "g.npz"
    hist = ttrain.main(["--grids", "--device", "cpu", "--steps", "2", "--rays", "4",
                        "--n_images", "1", "--img_res", "4", "--out", str(out)])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    tree = load_params_npz(out)
    assert tree["implicit"]["encoding"]["embeddings"].shape == (6_098_108 * 2,)
    rows = teval.main(["--grids", "--device", "cpu", "--params", str(out), "--n_images", "1",
                       "--img_res", "2", "--split_n_pixels", "4", "--out_dir", str(tmp_path)])
    assert len(rows) == 1 and np.isfinite(rows[0][1])


# the hash grids whose level constants K6 and K5 take: the bench's, the
# parity tests', the card tests' (6 levels; 16 levels mixing dense levels of
# non-power-of-two sizes with hashed ones) and one level alone
LEVEL_CASES = {
    "bench": lambda: teval.bench_grids_config().implicit.grid,
    "parity": lambda: th.HashGridConfig(**GRID),
    "card-6": lambda: th.HashGridConfig(num_levels=6, base_resolution=16, log2_hashmap_size=12,
                                        desired_resolution=128, hash_scheme="add"),
    "card-16-xor": lambda: th.HashGridConfig(num_levels=16, base_resolution=3,
                                             log2_hashmap_size=15, desired_resolution=512,
                                             hash_scheme="xor"),
    "one-level": lambda: th.HashGridConfig(num_levels=1, base_resolution=17,
                                           desired_resolution=None),
}


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_constants_reproduce_the_modulo(case):
    """The kernels' per-level (mask, magic, shift), as _levels packs them,
    give idx % hms for every level over a sweep of uint32 indices (random,
    the ends of the range, and multiples of hms and their neighbours)."""
    from monosdf_torch.kernels.hash_encode import MAX_LEVELS, _levels, level_mod

    cfg = LEVEL_CASES[case]()
    desc, _, rows = _levels(cfg, 1.0, 1.0)
    d = np.array(list(desc), dtype=np.int64) % (1 << 32)  # the C side reads them as uint32
    L = int(d[0])
    assert L == cfg.num_levels and rows == cfg.table_size
    col = lambda i: d[1 + i * MAX_LEVELS:1 + i * MAX_LEVELS + L]
    rng = np.random.default_rng(0)
    base = np.concatenate([rng.integers(0, 2**32, 20000, dtype=np.uint64),
                           np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint64)])
    for hms, mask, magic, shift in zip(col(1), col(5), col(6), col(7)):
        k = np.arange(1, 200, dtype=np.uint64) * np.uint64(hms)
        idx = np.concatenate([base, k % 2**32, (k - 1) % 2**32, (k + 1) % 2**32])
        got = level_mod(idx, int(hms), int(mask), int(magic), int(shift))
        assert (got == idx % np.uint64(hms)).all(), (case, hms)

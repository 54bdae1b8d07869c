"""Parity of the port's conf path with the JAX package: the HOCON parser,
``build_configs`` field by field (the learning-rate factor and decay of the
grid confs included), the conf-to-kernel routing table of README.md, and
the specular head of the HDR conf (``rendering_apply`` with ``spec``, and
an eval render of the conf's model at widths an overlay cuts).

Every conf of ``confs/`` and every overlay pair the JAX package's tests
layer (tests/test_quality_gate.py) goes through both parsers and both
schemas. Parses are equal exactly; configs field by field, except the
fields listed at ``JAX_ONLY`` and the backends the routing rule sets.
"""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.config as jc
import monosdf_tpu.config.hocon as jhocon
import monosdf_tpu.models.fields as jf
import monosdf_tpu.models.monosdf as jm
from monosdf_tpu.ops.hashgrid import _kernels_eligible
import monosdf_torch.config as tc
import monosdf_torch.models.fields as tf
import monosdf_torch.models.monosdf as tm
from monosdf_torch.cli import eval as teval
from monosdf_torch.params import flatten_tree, load_jax_params
from torch_parity import jit_ref, ray_batch

torch.set_num_threads(2)  # leave the cores to the other test workers

REPO = Path(__file__).resolve().parent.parent
CONFS = sorted(p.name for p in (REPO / "confs").glob("*.conf"))
# the overlays tests/test_quality_gate.py layers over a shipped conf, and the
# batch-scaling overlay over the grid conf it names
_TINY = ("tpu{ sampler_backend = jnp, diff_backend = jnp, rgb_backend = jnp,"
         " sampler_machinery = jnp, mixed_precision = False, compute_dtype = float32 }\n"
         "model{ feature_vector_size = 64,"
         " implicit_network{ dims = [64, 64, 64, 64], skip_in = [2] },"
         " rendering_network{ dims = [64, 64] },"
         " ray_sampler{ N_samples = 32, N_samples_eval = 64, N_samples_extra = 16 } }\n")
OVERLAYS = {
    "qgate": ("synth_sphere_tiny.conf",
              "train{ num_pixels = 256 }\ndataset{ use_mask = True }\n"),
    "torus": ("synth_sphere_tiny.conf",
              "train{ num_pixels = 256, expname = synth_torus_tiny }\n"
              "dataset{ use_mask = True, data_dir = torus_scene }\n"),
    "union": ("synth_sphere_tiny.conf",
              "train{ num_pixels = 256, expname = synth_union_tiny }\n"
              "dataset{ use_mask = True, data_dir = union_scene }\n"
              "model{ rendering_network{ per_image_code = True } }\n"),
    "room": ("synth_room_quality.conf",
             "train{ num_pixels = 256, expname = synth_room_tiny,"
             " checkpoint_freq = 500, plot_freq = 2000 }\n"
             "plot{ resolution = 64 }\ndataset{ img_res = [48, 48] }\n" + _TINY),
    "hdr": ("synth_union_hdr.conf",
            "train{ num_pixels = 256, expname = synth_hdr_tiny,"
            " checkpoint_freq = 500, plot_freq = 2000 }\n"
            "plot{ resolution = 64 }\ndataset{ img_res = [48, 48] }\n" + _TINY),
    "b4096": ("synth_sphere_quality_grids.conf",
              (REPO / "confs" / "synth_sphere_grids_b4096.conf").read_text()),
}

# fields of the JAX configs the port's lack, each with the port's field that
# carries its value (None: a TPU layout knob with no value of its own)
JAX_ONLY = {
    "MonoSDFConfig": {"if_hdr": "rendering.if_hdr",
                      "scene_bounding_sphere": "sampler.scene_bounding_sphere",
                      "fold_eikonal": None},
    "SamplerConfig": {"merge_impl": None},
    "OptimConfig": {"fused": None},
}


def _conf(pkg, name: str) -> dict:
    """The conf tree of a shipped conf or of an OVERLAYS pair, parsed by
    ``pkg`` (monosdf_tpu.config or monosdf_torch.config)."""
    if name in OVERLAYS:
        base, text = OVERLAYS[name]
        return pkg.merge_configs(pkg.parse_hocon_file(str(REPO / "confs" / base)),
                                 pkg.parse_hocon(text))
    return pkg.parse_hocon_file(str(REPO / "confs" / name))


ALL = CONFS + list(OVERLAYS)


@pytest.mark.parametrize("name", ALL)
def test_conf_parses_as_jax(name):
    assert _conf(tc, name) == _conf(jc, name)


def test_hocon_errors_and_merges_as_jax():
    text = "train{ a = 1, b = [1, 2.5, x] }\nmodel { x: \"q\\\\n\" // c\n  n { y = on } }"
    assert tc.parse_hocon(text) == jc.parse_hocon(text)
    over = tc.parse_hocon("model{ n{ z = null } }")
    assert tc.merge_configs(tc.parse_hocon(text), over) == jc.merge_configs(jc.parse_hocon(text),
                                                                           over)
    for bad in ("a = {", "a b", "{ = 1"):
        with pytest.raises(tc.HoconError):
            tc.parse_hocon(bad)
        with pytest.raises(jhocon.HoconError):
            jc.parse_hocon(bad)


def _routed(tmodel) -> tuple:
    """(sampler_backend, diff_backend) the routing rule gives a port model."""
    return tmodel.sampler_backend, tmodel.diff_backend


def _compare(jobj, tobj, path: str, skip: set):
    """Every field of the JAX dataclass ``jobj`` against the port's, except
    the paths in ``skip`` and the JAX_ONLY fields (checked against the
    port's field that carries them)."""
    jname = type(jobj).__name__
    tfields = {f.name for f in dataclasses.fields(tobj)}
    for f in dataclasses.fields(jobj):
        p = f"{path}.{f.name}" if path else f.name
        jv = getattr(jobj, f.name)
        if f.name not in tfields:
            assert f.name in JAX_ONLY.get(jname, {}), f"{p}: a JAX field the port lacks"
            carrier = JAX_ONLY[jname][f.name]
            if carrier is not None:
                tv = tobj
                for part in carrier.split("."):
                    tv = getattr(tv, part)
                assert tv == jv, p
            continue
        if p in skip:
            continue
        tv = getattr(tobj, f.name)
        if dataclasses.is_dataclass(jv):
            _compare(jv, tv, p, skip)
        else:
            assert tv == jv, f"{p}: port {tv!r}, JAX {jv!r}"


@functools.lru_cache(maxsize=None)
def _built(name: str):
    return jc.build_configs(_conf(jc, name)), tc.build_configs(_conf(tc, name))


@pytest.mark.parametrize("name", ALL)
def test_build_configs_match_jax_field_by_field(name):
    jexp, texp = _built(name)
    m = jexp.model
    grid_kernels = m.implicit.use_grid and "pallas" in (m.implicit.grid.build_impl,
                                                        m.implicit.grid.fold_impl)
    # the routing rule's backends; every other field equals JAX's
    skip = {"model.sampler_backend", "model.diff_backend"} if grid_kernels else set()
    _compare(jexp, texp, "", skip)
    if grid_kernels:
        assert _routed(texp.model) == ("pallas", "pallas")
    # faults 1 and 2 of the conf path: the schema's factor and decay, not the
    # optimizer dataclass's 20 and 0.25
    raw_train = _conf(tc, name).get("train", {})
    assert texp.optim.lr_factor_for_grid == raw_train.get("lr_factor_for_grid", 1.0)
    assert texp.optim.sched_decay_rate == raw_train.get("sched_decay_rate", 0.1)
    assert texp.optim.decay_steps == texp.max_total_iters


def test_the_grid_confs_get_factor_one_and_decay_over_their_run():
    for name in ("synth_sphere_quality_grids.conf", "synth_torus_quality_grids.conf"):
        jexp, texp = _built(name)
        assert texp.optim.grid_mode and texp.optim.lr_factor_for_grid == 1.0
        assert (texp.optim.sched_decay_rate, texp.optim.decay_steps) == (0.1, 20000)
        assert (jexp.optim.lr_factor_for_grid, jexp.optim.sched_decay_rate) == (1.0, 0.1)
        # the encoding group's rate is the base rate under the conf
        model = tm.init_monosdf(texp.model, device="cpu")
        from monosdf_torch.train import make_optimizer
        adam, _ = make_optimizer(texp.optim, model.named_parameters())
        assert [g["lr"] for g in adam.param_groups] == [texp.optim.learning_rate] * 3


def test_hard_wired_runs_keep_the_dataclass_factor_and_decay():
    """cli/train.py's hard-wired --grids and --union runs (and the bench)
    train with OptimConfig(): the JAX dataclass's factor 20 and decay 0.25
    over 150,000 steps, not the schema's."""
    import monosdf_tpu.train.optim as joptim
    from monosdf_torch.cli import train as ttrain
    from monosdf_torch.train import OptimConfig

    ours, theirs = OptimConfig(), joptim.OptimConfig()
    assert (ours.lr_factor_for_grid, ours.sched_decay_rate, ours.decay_steps) == (20.0, 0.25,
                                                                                150_000)
    assert all(getattr(ours, f.name) == getattr(theirs, f.name)
               for f in dataclasses.fields(ours))
    cfg = teval.bench_grids_config("float32")
    model = tm.init_monosdf(cfg, device="cpu")
    step = ttrain.make_trainer(model, cfg)
    (adam,) = [c.cell_contents for c in step.__closure__
               if isinstance(c.cell_contents, torch.optim.Adam)]
    assert sorted(g["lr"] for g in adam.param_groups) == [5e-4, 5e-4, 5e-4 * 20]


def test_sweep_oct_is_refused_as_jax_refuses_it():
    for text in ("tpu{ sweep_oct = True }",
                 "tpu{ sweep_oct = True, sweep_max_level = 4 }\nmodel{ Grid_MLP = True }"):
        with pytest.raises(ValueError, match="sweep_oct"):
            jc.build_configs(jc.parse_hocon(text))
        with pytest.raises(ValueError, match="sweep_oct"):
            tc.build_configs(tc.parse_hocon(text))


def test_union_conf_is_the_hard_wired_union_model():
    """build_configs(synth_union_quality.conf) is cli/eval.py's
    union_codes_config except in the fields listed here: the conf leaves
    PE(6) for the view directions at 4 (both), the hash grid unused."""
    _, texp = _built("synth_union_quality.conf")
    hard = teval.union_codes_config("bfloat16")
    differ = []

    def walk(a, b, path):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            p = f"{path}.{f.name}" if path else f.name
            if dataclasses.is_dataclass(va):
                walk(va, vb, p)
            elif va != vb:
                differ.append(p)

    walk(texp.model, hard, "")
    # the grid knobs of an MLP model (the schema's defaults, unused), and the
    # schema's machinery dtype default
    assert sorted(differ) == ["implicit.grid.table_dtype"], differ


# -- the routing table of README.md ------------------------------------------

# the Pallas kernels of the JAX package a training run reaches (steps,
# renders, mesh), by the ids of PERF.md's table
def jax_pallas_kernels(m) -> tuple:
    grid, g, ren = m.implicit.use_grid, m.implicit.grid, m.rendering
    out = []
    if m.sampler_backend == "pallas":
        out.append("K1-PE" if m.sweep_pe_in_kernel and not grid else "K1")
    if m.sampler.machinery == "pallas":
        out.append("K4")
    if m.diff_backend == "pallas":
        out += ["K7f", "K7b"] if grid else ["K2f", "K2b"]
    kernel_head = ren.mode == "idr" and not ren.spec
    if m.rgb_backend == "fused" and m.diff_backend == "pallas" and not grid and kernel_head:
        out += ["K3f", "K3b"]
    elif m.rgb_backend == "pallas" and kernel_head:
        out.append("K8a")
    # monosdf_tpu/ops/hashgrid.py:450,621: the quad layout's fold, where
    # the JAX package's own eligibility test passes
    if grid and g.layout == "quad" and g.scatter_impl == "fold" and _kernels_eligible(g):
        out += [k for k, impl in (("K6", g.build_impl), ("K5", g.fold_impl)) if impl == "pallas"]
    return tuple(out)


def readme_routes() -> dict:
    """conf -> (JAX kernels, port kernels) from README.md's routing table."""
    text = (REPO / "README.md").read_text()
    rows = {}
    for line in text.splitlines():
        m = re.fullmatch(r"\| `(\S+\.conf)` \| (.*?) \| (.*?) \|", line.strip())
        if m:
            split = lambda s: tuple(x.strip("` ") for x in s.split(",") if x.strip("` -"))
            rows[m.group(1)] = (split(m.group(2)), split(m.group(3)))
    return rows


@pytest.mark.parametrize("name", CONFS)
def test_readme_routing_table(name):
    jexp, texp = _built(name)
    rows = readme_routes()
    assert name in rows, f"README.md's routing table has no row for {name}"
    jax_k, port_k = rows[name]
    assert jax_k == jax_pallas_kernels(jexp.model)
    assert port_k == tc.routed_kernels(texp.model)
    # the kernel routing rule: each JAX kernel has its counterpart in the port's route
    counterpart = {"K1": "sdf_mlp", "K1-PE": "sdf_mlp_pe", "K4": "sampler_machinery",
                   "K2f": "sdf_grad", "K2b": "sdf_grad_bwd", "K3f": "radiance_norm",
                   "K3b": "radiance_norm_bwd", "K6": "hash_encode", "K5": "hash_encode_bwd",
                   "K7f": "sdf_grad_grid", "K7b": "sdf_grad_grid_bwd", "K8a": "radiance_split"}
    assert {counterpart[k] for k in jax_k} <= set(port_k)


# -- the specular head ---------------------------------------------------------

SPEC = dict(feature_vector_size=16, dims=(32, 32), multires_view=2, if_hdr=True, spec=True,
            per_image_code=True, code_dim=4, max_images=3)


def _spec_inputs(n=40, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(n, 3), f(n, 3), f(n, 3), f(n, 16), f(n, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_head_matches_jax(dtype):
    """rendering_apply with the diffuse + specular head: outputs at 2e-5 and
    every parameter and input gradient of a weighted sum at 2e-4 (float32;
    bf16 operands with float32 sums: 1e-2)."""
    jcfg, tcfg = jf.RenderingNetConfig(**SPEC), tf.RenderingNetConfig(**SPEC)
    jparams = jf.init_rendering_net(jax.random.PRNGKey(3), jcfg)
    assert jparams["lin1"]["v"].shape == (29, 32)  # layer num_layers - 3 takes dims - 3
    net = load_jax_params(tf.RenderingNet(tcfg), jax.tree_util.tree_map(np.asarray, jparams))
    x = _spec_inputs()
    w = np.random.default_rng(1).normal(size=(x[0].shape[0], 3)).astype(np.float32)
    jd, td = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)

    def jloss(p, xs):
        out = jf.rendering_apply(p, jcfg, *xs, dtype=jd)
        return jnp.sum(out["rgb"] * w) + jnp.sum(out["rgb_spec"] * w), out

    (_, jout), jg = jit_ref(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jparams, tuple(map(jnp.asarray, x)))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in x]
    tout = tf.rendering_apply(net, tcfg, *tx, dtype=td)
    (torch.sum(tout["rgb"] * torch.from_numpy(w))
     + torch.sum(tout["rgb_spec"] * torch.from_numpy(w))).backward()
    atol, gtol = (2e-5, 2e-4) if dtype == "float32" else (1e-2, 1e-2)
    assert set(tout) == {"rgb", "rgb_diff", "rgb_spec"}
    for k in tout:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=atol,
                                   err_msg=k)
    jflat = _flat(jg[0])
    for name, p in net.named_parameters():
        if name == "embeddings":  # the code comes in as an input here
            assert p.grad is None and not jflat[name].any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), jflat[name], atol=gtol, rtol=gtol,
                                   err_msg=name)
    for a, b in zip(tx[1:4], jg[1][1:4]):  # normals, view directions, features
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=gtol, rtol=gtol)
    with pytest.raises(ValueError, match="HDR"):
        tf.rendering_apply(net, dataclasses.replace(tcfg, if_hdr=False), *tx)


def _flat(tree) -> dict:
    """A JAX tree as {dotted parameter name: numpy array}."""
    return {k.replace("/", "."): v for k, v in
            flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


def test_hdr_conf_eval_render_matches_jax():
    """The model of confs/synth_union_hdr.conf (spec head, per-image codes,
    white background, HDR) at the widths of the quality gate's overlay
    (float32, plain backends): the samples of an eval render as
    tests/test_torch_render.py holds them (1e-3), and the render at JAX's
    samples, rgb_spec_values included, at 2e-5."""
    jexp, texp = _built("hdr")
    jcfg, tcfg = jexp.model, texp.model
    assert tcfg.rendering.spec and tcfg.rendering.if_hdr and tc.routed_kernels(tcfg) == ()
    jcfg = dataclasses.replace(jcfg, sampler=dataclasses.replace(jcfg.sampler, max_total_iters=2))
    tcfg = dataclasses.replace(tcfg, sampler=dataclasses.replace(tcfg.sampler, max_total_iters=2))
    jparams = jm.init_monosdf(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jparams)
    model = load_jax_params(tm.init_monosdf(tcfg, device="cpu"), tree)
    rays = ray_batch(8, seed=3)
    codes = tree["rendering"]["embeddings"][np.arange(8) % 3]

    @jit_ref
    def jrender(p, r, c):
        return jm.render_rays(p, jcfg, r, jax.random.PRNGKey(0), training=False, image_code=c)

    jout = jrender(jax.tree_util.tree_map(jnp.asarray, tree),
                   {k: jnp.asarray(v) for k, v in rays.items()}, jnp.asarray(codes))
    trays = {k: torch.from_numpy(v) for k, v in rays.items()}
    tout = tm.render_rays(model, tcfg, trays, image_code=torch.from_numpy(codes))
    np.testing.assert_allclose(tout["z_vals"].numpy(), np.asarray(jout["z_vals"]), atol=1e-3)
    at = tm.render_samples(model, tcfg, trays, torch.from_numpy(np.array(jout["z_vals"])),
                           torch.from_numpy(codes))
    for k in ("rgb_values", "depth_values", "normal_map", "rgb_spec", "rgb_spec_values"):
        np.testing.assert_allclose(at[k].numpy(), np.asarray(jout[k]), atol=2e-5, err_msg=k)
    assert np.abs(np.asarray(jout["rgb_spec_values"])).max() > 0

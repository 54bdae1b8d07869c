"""Parity of the port's plain modules with the JAX package, and the weight
bridge (the import and device guards are in test_torch_guards.py).

Inputs are made with numpy from a seed and go through both packages;
float32 tolerance 2e-5 per component unless stated.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.nn as jnn
import monosdf_tpu.ops.chunking as jchunk
import monosdf_tpu.ops.density as jden
import monosdf_tpu.ops.embedder as jemb
import monosdf_tpu.ops.geometry as jgeo
import monosdf_tpu.ops.render as jren
import monosdf_tpu.ops.sampler as js
import monosdf_tpu.models.fields as jf
import monosdf_tpu.models.monosdf as jm
import monosdf_torch.nn as tnn
import monosdf_torch.ops.chunking as tchunk
import monosdf_torch.ops.density as tden
import monosdf_torch.ops.embedder as temb
import monosdf_torch.ops.geometry as tgeo
import monosdf_torch.ops.render as tren
import monosdf_torch.ops.sampler as ts
import monosdf_torch.models.fields as tf
import monosdf_torch.models.monosdf as tm
from monosdf_torch import params as tparams
from torch_parity import both_models, configs, jit_ref, ray_batch

torch.set_num_threads(2)  # leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)


def _f32(*shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t.detach().numpy()), np.asarray(j), **{**TOL, **kw})


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(fn, *args):
    """fn jitted over numpy args: one XLA compile instead of one per op."""
    return jit_ref(fn)(*jax.tree_util.tree_map(jnp.asarray, args))


@functools.lru_cache(maxsize=None)
def _jax_init_tree():
    """(JAX config, port config, the JAX package's init_monosdf pytree as numpy)."""
    jcfg, tcfg = configs(False)
    jparams = jit_ref(lambda k: jm.init_monosdf(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree_util.tree_map(np.asarray, jparams)


# -- nn ----------------------------------------------------------------------

def test_softplus_beta():
    x = _f32(257, lo=-0.5, hi=0.5)
    _close(tnn.softplus_beta(_t(x)), _j(jnn.softplus_beta, x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("keep_dtype", [False, True])
def test_apply_linear(dtype, keep_dtype):
    v, g, b, x = _f32(24, 16, seed=1), _f32(16, seed=2), _f32(16, seed=3), _f32(9, 24, seed=4)
    jp = {"v": jnp.asarray(v), "g": jnp.asarray(g), "b": jnp.asarray(b)}
    lin = tnn.Linear(24, 16, device="cpu")
    tparams.load_jax_params(lin, {"v": v, "g": g, "b": b})
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    y_j = _j(lambda p, y: jnn.apply_linear(p, y, dtype=jd, keep_dtype=keep_dtype), jp, x)
    y_t = tnn.apply_linear(lin, _t(x), dtype=td, keep_dtype=keep_dtype)
    assert str(y_t.dtype).split(".")[-1] == str(y_j.dtype)
    # bf16 with keep_dtype: one bf16 rounding of values ~1 (ulp 2^-7 ~ 8e-3)
    # may fall on the other side after float32 sums in another order
    tol = TOL if not (jd and keep_dtype) else dict(atol=8e-3)
    _close(y_t.float(), np.asarray(y_j, np.float32), **tol)


def test_geometric_init_matches_jax_in_distribution():
    """The port draws with a torch.Generator, so its bits differ from
    jax.random; each layer must have the same zero pattern, the same biases,
    g = |v| per column, and the same weight spread."""
    _, tcfg, tree = _jax_init_tree()
    net = tf.init_implicit_net(tcfg.implicit, torch.Generator().manual_seed(0))
    for l, lin in enumerate(net.layers()):
        jp = tree["implicit"][f"lin{l}"]
        tv = lin.v.detach().numpy()
        assert tv.shape == jp["v"].shape
        np.testing.assert_array_equal(tv == 0, jp["v"] == 0)
        np.testing.assert_array_equal(lin.b.detach().numpy(), jp["b"])
        _close(lin.g, np.linalg.norm(tv, axis=0))
        nz = tv != 0
        assert 0.85 < tv[nz].std() / jp["v"][nz].std() < 1.15, l
        assert abs(tv[nz].mean() - jp["v"][nz].mean()) < 0.1 * jp["v"][nz].std() + 1e-3, l


# -- ops ---------------------------------------------------------------------

def test_positional_encoding():
    x = _f32(11, 3, lo=-1.1, hi=1.1)
    for multires in (0, 4, 6):
        _close(temb.positional_encoding(_t(x), multires),
               _j(lambda y: jemb.positional_encoding(y, multires), x))
        assert temb.pe_dim(multires) == jemb.pe_dim(multires)


def test_density():
    s, beta = _f32(64, lo=-0.3, hi=0.3), np.float32(0.05)
    _close(tden.get_beta(_t(np.float32(-0.1))), _j(jden.get_beta, np.float32(-0.1)))
    _close(tden.laplace_density(_t(s), _t(beta)), _j(jden.laplace_density, s, beta),
           rtol=2e-5, atol=2e-4)  # values up to 1/beta = 20


def test_geometry():
    B, N = 2, 5
    uv = _f32(B, N, 2, lo=0, hi=32)
    K = np.tile(np.array([[30.0, 0.3, 16, 0], [0, 31.0, 15, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32), (B, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    pose[:, :3, 3] = _f32(B, 3, seed=7)
    d_t, c_t = tgeo.get_camera_params(_t(uv), _t(pose), _t(K))
    d_j, c_j = _j(jgeo.get_camera_params, uv, pose, K)
    _close(d_t, d_j)
    _close(c_t, c_j)
    o = _f32(40, 3, lo=-2, hi=2, seed=8)
    d = _f32(40, 3, seed=9)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tgeo.get_sphere_intersections(_t(o), _t(d), 1.1),
           _j(lambda a, b: jgeo.get_sphere_intersections(a, b, 1.1), o, d), atol=1e-5)
    for a, b in zip(tgeo.near_far_from_cube(_t(o), _t(d), 1.1, 0.0, 3.85),
                    _j(lambda a, b: jgeo.near_far_from_cube(a, b, 1.1, 0.0, 3.85), o, d)):
        _close(a, b)


def test_rays_from_camera():
    uv = _f32(1, 6, 2, lo=0, hi=16)
    K = np.eye(4, dtype=np.float32)[None]
    K[0, 0, 0] = K[0, 1, 1] = 20.0
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, :3, 3] = [0.1, 0.2, -1.5]
    r_t = tm.rays_from_camera(_t(uv), _t(pose), _t(K))
    r_j = _j(jm.rays_from_camera, uv, pose, K)
    for k in r_j:
        _close(r_t[k], r_j[k])


def test_volume_rendering():
    z = np.sort(_f32(6, 20, lo=0, hi=3), axis=-1)
    dens = _f32(6, 20, lo=0, hi=5, seed=1)
    w_t = tren.volume_rendering_weights(_t(z), _t(dens))
    w_j = _j(jren.volume_rendering_weights, z, dens)
    _close(w_t, w_j)
    rgb, nrm, sc = _f32(6, 20, 3, seed=2), _f32(6, 20, 3, seed=3), _f32(6, 1, seed=4)
    for a, b in zip(tren.render_ray_outputs(w_t, _t(z), _t(rgb), _t(nrm), _t(sc)),
                    _j(jren.render_ray_outputs, w_j, z, rgb, nrm, sc)):
        _close(a, b)


@pytest.mark.parametrize("n_total", [10, 12])
def test_chunked_apply(n_total):
    a, b = _f32(n_total, 3), _f32(n_total, 2, seed=1)

    def f(x, y):
        return {"s": (x * x).sum(-1, keepdims=True) + y[:, :1], "y": y * 2}

    out_t = tchunk.chunked_apply(f, n_total, 4, _t(a), _t(b))
    out_j = jchunk.chunked_apply(f, n_total, 4, jnp.asarray(a), jnp.asarray(b))
    for k in out_j:
        _close(out_t[k], out_j[k])


# -- sampler -----------------------------------------------------------------

def test_linspace_is_bitwise_jnp():
    for n in (2, 32, 64, 98, 128):
        np.testing.assert_array_equal(ts.linspace(0.0, 1.0, n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


@pytest.mark.parametrize("n_buf", [128, 256, 384, 512, 640])
def test_final_tail_extra_indices_identical(n_buf):
    """linspace(0, n_buf-1, 32) truncated to int: a float linspace that
    differs by one ulp could pick a neighbouring sample."""
    j = np.asarray(jnp.linspace(0, n_buf - 1, 32).astype(jnp.int32))
    np.testing.assert_array_equal(ts.extra_sample_indices(n_buf, 32).numpy(), j)


def test_sampler_config_rejects_unknown_knobs():
    with pytest.raises(ValueError, match="pallas_fused"):
        ts.SamplerConfig(machinery="pallas_fused")
    with pytest.raises(TypeError):  # knobs the port does not take
        ts.SamplerConfig(merge_impl="sort")
    assert ts.SamplerConfig().far_value == js.SamplerConfig().far_value
    assert ts.SamplerConfig().total_samples == js.SamplerConfig().total_samples == 98


def _sorted_z(R=6, N=128, seed=0):
    return np.sort(_f32(R, N, lo=0.0, hi=3.85, seed=seed), axis=-1)


@pytest.mark.parametrize("intersection", ["cube", "sphere", "none"])
def test_uniform_z_vals(intersection):
    rays = ray_batch(8)
    cfg_t = ts.SamplerConfig(intersection=intersection)
    cfg_j = js.SamplerConfig(intersection=intersection)
    z_t, _, far_t = ts.uniform_z_vals(_t(rays["rays_o"]), _t(rays["rays_d"]), cfg_t, 128)
    z_j, _, far_j = _j(lambda o, d: js.uniform_z_vals(o, d, cfg_j, 128, None, False),
                       rays["rays_o"], rays["rays_d"])
    _close(z_t, z_j)
    _close(far_t, far_j)


def test_sample_pdf():
    z = _sorted_z()
    pdf = _f32(6, 127, lo=0.1, hi=1, seed=1)
    pdf[:, 40:60] = 0.0  # a flat CDF run exercises the denom < 1e-5 rule
    u = np.tile(np.asarray(jnp.linspace(0.0, 1.0, 128)), (6, 1))
    _close(ts._sample_pdf(_t(z), _t(pdf), _t(u)),
           _j(js._sample_pdf, z, pdf, u), atol=1e-5)


def test_d_star_and_error_bound():
    z = _sorted_z(seed=2)
    sdf = _f32(6, 128, lo=-0.3, hi=0.5, seed=3)
    ds_t = ts._d_star(_t(z), _t(sdf))
    ds_j = _j(js._d_star, z, sdf)
    _close(ds_t, ds_j)
    dists = np.diff(z, axis=-1)
    beta = np.full((6, 1), 0.05, np.float32)
    _close(ts._error_bound(_t(beta), _t(sdf), _t(z), _t(dists), ds_t),
           _j(js._error_bound, beta, sdf, z, dists, ds_j), rtol=1e-4)


def test_merge_sorted():
    z_old, z_new = _sorted_z(seed=4), _sorted_z(seed=5)
    s_old, s_new = _f32(6, 128, seed=6), _f32(6, 128, seed=7)
    z_t, s_t = ts._merge_sorted_sort(_t(z_old), _t(s_old), _t(z_new), _t(s_new))
    z_j, s_j = js._merge_sorted_sort(*(jnp.asarray(a) for a in (z_old, s_old, z_new, s_new)))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


# -- fields (plain path) -----------------------------------------------------

@pytest.mark.parametrize("bounding", [1.1, 0.0])
def test_sdf_feat_grad_plain(bounding):
    jcfg, tcfg = configs(False)
    jimp = jcfg.implicit.__class__(**{**jcfg.implicit.__dict__, "sdf_bounding_sphere": bounding})
    timp = tcfg.implicit.__class__(**{**tcfg.implicit.__dict__, "sdf_bounding_sphere": bounding})
    jparams, model, _ = both_models(jcfg, tcfg)
    x = _f32(40, 3, lo=-1.2, hi=1.2, seed=11)
    out_t = tf.sdf_feat_grad(model.implicit, timp, _t(x))
    out_j = jit_ref(lambda p, y: jf.sdf_feat_grad(p, jimp, y))(jparams["implicit"], jnp.asarray(x))
    for a, b in zip(out_t, out_j):
        _close(a, b)
    _close(tf.sdf_value(model.implicit, timp, _t(x)),
           _j(lambda p, y: jf.sdf_value(p, jimp, y), jparams["implicit"], x))


@pytest.mark.parametrize("variant", [{}, {"mode": "nerf", "d_in": 3}, {"per_image_code": True},
                                     {"if_hdr": True}], ids=["idr", "nerf", "code", "hdr"])
def test_rendering_apply_plain(variant):
    jcfg, tcfg = configs(False)
    jren_cfg = jcfg.rendering.__class__(**{**jcfg.rendering.__dict__, **variant})
    tren_cfg = tcfg.rendering.__class__(**{**tcfg.rendering.__dict__, **variant})
    net = tf.init_rendering_net(tren_cfg, torch.Generator().manual_seed(1))
    jparams = tparams.params_to_tree(net)
    pts, nrm, vd = _f32(30, 3), _f32(30, 3, seed=1), _f32(30, 3, seed=2)
    feat, code = _f32(30, 32, seed=3), _f32(30, 32, seed=4)
    code_t = _t(code) if tren_cfg.per_image_code else None
    out_t = tf.rendering_apply(net, tren_cfg, *map(_t, (pts, nrm, vd, feat)), code_t)
    out_j = _j(lambda p, *a: jf.rendering_apply(p, jren_cfg, *a), jparams, pts, nrm, vd, feat,
               code if tren_cfg.per_image_code else None)
    _close(out_t["rgb"], out_j["rgb"])


# -- data, metrics, bridge ---------------------------------------------------

def test_synthetic_scene_and_psnr():
    from monosdf_tpu.data.synthetic import make_synthetic_sphere_scene as jscene
    from monosdf_tpu.eval.metrics import psnr as jpsnr
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene as tscene
    from monosdf_torch.eval.metrics import psnr as tpsnr

    a, b = tscene(n_images=2, img_res=8), jscene(n_images=2, img_res=8)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    x, y = _f32(8, 8, 3), _f32(8, 8, 3, seed=1)
    assert tpsnr(x, y) == jpsnr(x, y)


def test_param_bridge_roundtrip(tmp_path):
    jcfg, tcfg = configs(True)
    _, model, tree = both_models(jcfg, tcfg)
    path = tmp_path / "params.npz"
    tparams.save_params_npz(path, tree)
    back = tparams.load_params_npz(path)
    model2 = tparams.load_jax_params(tm.init_monosdf(tcfg, seed=1, device="cpu"), back)
    for (n1, p1), (n2, p2) in zip(model.named_parameters(), model2.named_parameters()):
        assert n1 == n2
        assert torch.equal(p1, p2)
    assert tparams.params_to_tree(model2)["implicit"]["lin0"]["g"].shape == (48,)
    del tree["density"]
    with pytest.raises(KeyError):
        tparams.load_jax_params(model2, tree)


def test_param_bridge_takes_jax_init_monosdf():
    """The pytree of the JAX package's own init_monosdf fills the port's
    model key for key, value for value."""
    _, tcfg, tree = _jax_init_tree()
    model = tparams.load_jax_params(tm.init_monosdf(tcfg, device="cpu"), tree)
    flat = tparams.flatten_tree(tree)
    assert len(flat) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[name.replace(".", "/")])

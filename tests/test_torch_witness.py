"""The float64 witnesses of K1 and K4 (``monosdf_torch/scripts/witness.py``)
on the CPU: the functions ``chip_smoke.py`` renders with in the kernels'
places to tell which of the kernel render and the plain render lies nearer
the truth.

* At float32 rounding points (``dtype`` None) each witness is the kernel's
  function in float64 throughout, so it is held to the JAX package's jnp
  path run in float64 (``jax.enable_x64``): K1 to ``implicit_apply``'s SDF
  column on the effective weights JAX forms in float64 (1e-9), K4 to the
  jnp machinery (``monosdf_tpu/ops/sampler.py:445-514``, built from the
  package's ``_error_bound`` and ``laplace_density``): beta equal, the pdf
  within 1e-9 relative (float64 sums in another order; the final draw's
  weights, read back from ``weights + 1e-5``, within 1e-19).
* At bf16 rounding points the JAX jnp path has no bf16 roundings, so each
  witness is held to the port's plain version, which rounds at the same
  points and sums in float32: K1 within two output bf16 ulps (1.6e-2, the
  repo's K1 bf16 bar) with its mean difference below a tenth of an ulp;
  K4's beta within one bisection step of the bracket and its pdf within
  phase 3's bf16 bar (1e-5 + 2e-2 relative).
* On float32 inputs every witness returns float32, as the kernel it
  stands in for.

The file takes about 3 s of CPU alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.models.fields as jf
import monosdf_tpu.ops.sampler as js
from monosdf_tpu.ops.density import laplace_density as jlaplace
from monosdf_tpu.ops.pallas_mlp import effective_linear_weights
from monosdf_torch.kernels.sampler_machinery import sampler_iter_machinery_plain
from monosdf_torch.kernels.sdf_mlp import sdf_mlp_plain
from monosdf_torch.ops.embedder import positional_encoding
from monosdf_torch.ops.sampler import _d_star
from monosdf_torch.scripts.witness import k1_float64, k4_float64
from torch_parity import both_models, configs, jit_ref

torch.set_num_threads(2)  # leave the cores to the other test workers


@pytest.fixture(scope="module")
def k1_case():
    """The parity model's implicit network: its effective weights (last layer
    cut to the SDF column) in float64 as JAX forms them, and in float32 as
    the port's kernels take them; points beyond the 1.1 sphere too."""
    jcfg, tcfg = configs(True)
    _, model, tree = both_models(jcfg, tcfg)
    x = np.random.default_rng(0).uniform(-1.15, 1.15, (300, 3))
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                     tree["implicit"])
        ref = np.asarray(jit_ref(lambda p, y: jf.implicit_apply(p, jcfg.implicit, y))(
            p64, jnp.asarray(x)))[:, :1]
        jws, jbs = effective_linear_weights(p64, jcfg.implicit.num_layers)
        ws64 = [torch.tensor(np.asarray(a)) for a in jws]
        bs64 = [torch.tensor(np.asarray(a)) for a in jbs]
    ws64[-1], bs64[-1] = ws64[-1][:, :1], bs64[-1][:1]
    assert ref.dtype == np.float64 and ws64[0].dtype == torch.float64
    return jcfg, x, ref, ws64, bs64


def test_k1_witness_is_the_jnp_path_in_float64(k1_case):
    jcfg, x, ref, ws64, bs64 = k1_case
    emb = positional_encoding(torch.from_numpy(x), jcfg.implicit.multires)
    out = k1_float64(ws64, bs64, emb, jcfg.implicit.skip_in)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-9, rtol=0)
    # on float32 inputs it stands in for K1: float32 out, within float32 sums of the plain
    ws, bs = [w.float() for w in ws64], [b.float() for b in bs64]
    emb32 = emb.float()
    w32 = k1_float64(ws, bs, emb32, jcfg.implicit.skip_in, packed=object())
    assert w32.dtype == torch.float32
    np.testing.assert_allclose(w32.numpy(), sdf_mlp_plain(ws, bs, emb32, jcfg.implicit.skip_in),
                               atol=2e-5, rtol=0)


def test_k1_witness_rounds_where_the_kernel_rounds_in_bf16(k1_case):
    jcfg, x, _, ws64, bs64 = k1_case
    ws, bs = [w.float() for w in ws64], [b.float() for b in bs64]
    emb = positional_encoding(torch.from_numpy(x).float(), jcfg.implicit.multires)
    out = k1_float64(ws, bs, emb, jcfg.implicit.skip_in, torch.bfloat16)
    plain = sdf_mlp_plain(ws, bs, emb, jcfg.implicit.skip_in, torch.bfloat16)
    assert out.dtype == torch.float32 and torch.equal(out, out.bfloat16().float())
    d = (out - plain).abs()
    assert float(d.max()) <= 1.6e-2 and float(d.mean()) <= 7.8e-4
    # and it is not the float32-rounding witness
    assert not torch.equal(out, k1_float64(ws, bs, emb, jcfg.implicit.skip_in))


def _k4_inputs(R=8, N=256, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 3.85, (R, N)), axis=-1)
    surf = rng.uniform(0.8, 2.5, (R, 1))
    sdf = np.tanh(surf - z) * 0.6 + 0.01 * rng.standard_normal((R, N))
    z, sdf = z.astype(dtype), sdf.astype(dtype)
    dists = np.diff(z, axis=-1)
    dists_tail = np.concatenate([dists, np.full((R, 1), 1e10)], -1).astype(dtype)
    d_star = _d_star(torch.from_numpy(z), torch.from_numpy(sdf)).numpy()  # the port's
    d_star = np.pad(d_star, ((0, 0), (0, 1))).astype(dtype)
    beta_prev = np.sqrt(np.sum(dists**2, -1) / (4.0 * np.log(1.1)))[:, None].astype(dtype)
    return z, sdf, dists_tail, d_star, beta_prev


def _jnp_machinery(sdf, z, beta, beta0, eps, add_tiny, last, beta_iters):
    """monosdf_tpu/ops/sampler.py:445-514, the jnp machinery, to the pdf."""
    dists = z[:, 1:] - z[:, :-1]
    d_star = js._d_star(z, sdf)
    curr = js._error_bound(beta0, sdf, z, dists, d_star)
    beta = jnp.where(curr <= eps, beta0, beta)
    bmin, bmax = jnp.full_like(beta, beta0), beta
    for _ in range(beta_iters):
        mid = 0.5 * (bmin + bmax)
        ok = js._error_bound(mid[:, None], sdf, z, dists, d_star) <= eps
        bmax, bmin = jnp.where(ok, mid, bmax), jnp.where(ok, bmin, mid)
    beta = bmax
    dens = jlaplace(sdf, beta[:, None])
    dt = jnp.concatenate([dists, jnp.full_like(dists[:, :1], 1e10)], -1)
    fe = dt * dens
    trans = jnp.exp(-jnp.cumsum(jnp.concatenate([jnp.zeros_like(fe[:, :1]), fe[:, :-1]], -1), -1))
    if last:
        return beta, (1.0 - jnp.exp(-fe)) * trans
    err = jnp.cumsum(jnp.exp(-d_star / beta[:, None]) * dists**2 / (4.0 * beta[:, None] ** 2), -1)
    return beta, (jnp.clip(jnp.exp(err), max=1e6) - 1.0) * trans[:, :-1] + add_tiny


@pytest.mark.parametrize("last", [False, True])
def test_k4_witness_is_the_jnp_machinery_in_float64(last):
    z, sdf, dt, ds, bp = _k4_inputs(seed=1)
    beta0 = 0.01
    with jax.enable_x64():
        bj, pj = jit_ref(lambda *a: _jnp_machinery(*a, 0.1, 1e-6, last, 10))(
            jnp.asarray(sdf), jnp.asarray(z), jnp.asarray(bp[:, 0]), jnp.asarray(beta0))
        bj, pj = np.asarray(bj), np.asarray(pj)
    assert pj.dtype == np.float64
    bt, pt = k4_float64(*(torch.from_numpy(a) for a in (sdf, dt, ds, bp)),
                        torch.tensor(beta0, dtype=torch.float64), eps=0.1, add_tiny=1e-6,
                        last=last, beta_iters=10)
    assert bt.dtype == torch.float64
    np.testing.assert_array_equal(bt[:, 0].numpy(), bj)
    pt = pt.numpy()
    atol = 0.0
    if last:  # the machinery's final pdf is weights + 1e-5: a few float64 ulps of 1e-5 remain
        pt, atol = pt - 1e-5, 1e-19
    np.testing.assert_allclose(pt[:, :-1], pj[:, :-1] if last else pj, rtol=1e-9, atol=atol)


def test_k4_witness_rounds_where_the_kernel_rounds_in_bf16():
    z, sdf, dt, ds, bp = _k4_inputs(seed=2, dtype=np.float32)
    args = [torch.from_numpy(a) for a in (sdf, dt, ds, bp)] + [torch.tensor(0.01)]
    bw, pw = k4_float64(*args, eps=0.1, add_tiny=1e-6, last=False, dtype=torch.bfloat16)
    bp_, pp = sampler_iter_machinery_plain(*args, eps=0.1, add_tiny=1e-6, last=False,
                                           dtype=torch.bfloat16)
    assert bw.dtype == torch.float32 and pw.dtype == torch.float32
    assert float((bw - bp_).abs().max()) <= float(bp.max()) / 2**10
    assert float(((pw - pp).abs() / (1e-5 + 2e-2 * pp.abs())).max()) <= 1.0
    # the bf16 roundings change the pdf: not the float32-rounding witness
    _, pw32 = k4_float64(*args, eps=0.1, add_tiny=1e-6, last=False)
    assert not torch.equal(pw, pw32)

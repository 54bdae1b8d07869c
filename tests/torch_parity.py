"""Shared set-up of the port's parity tests (tests/test_torch_*.py): small
configurations built the same way in both packages, and parameters made by
the port's init, perturbed with seeded numpy noise and carried into both
packages (into the port by the weight bridge)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import jax
import jax.numpy as jnp

import monosdf_tpu.models.fields as jf
import monosdf_tpu.models.monosdf as jm
import monosdf_tpu.ops.hashgrid as jh
import monosdf_tpu.ops.sampler as js
import monosdf_torch.models.fields as tf
import monosdf_torch.models.monosdf as tm
import monosdf_torch.ops.hashgrid as th
import monosdf_torch.ops.sampler as ts
from monosdf_torch.params import load_jax_params, params_to_tree

IMPLICIT = dict(feature_vector_size=32, dims=(48, 48, 48, 48), skip_in=(2,), multires=4,
                inside_outside=True, bias=0.9, sdf_bounding_sphere=1.1)
RENDERING = dict(feature_vector_size=32, dims=(48, 48), multires_view=4)
# a tiny hash grid of the bench's kind: 4 levels (1 dense, 3 hashed 2^12-row
# levels), the 'add' hash, the quad layout with the Pallas fold and build
GRID = dict(num_levels=4, level_dim=2, base_resolution=16, log2_hashmap_size=12,
            desired_resolution=64, hash_scheme="add", layout="quad", scatter_impl="fold",
            fold_impl="pallas", build_impl="pallas", param_flat=True, sweep_oct_levels=2)
GRID_IMPLICIT = dict(feature_vector_size=16, dims=(32, 32), multires=6, inside_outside=True,
                     bias=0.9, use_grid=True, divide_factor=1.1, sdf_bounding_sphere=0.0)
GRID_RENDERING = dict(feature_vector_size=16, dims=(32, 32), multires_view=4)


def model_kwargs(kernels: bool, dtype: str = "float32", sampler=None, **overrides) -> dict:
    kw = dict(
        sampler={**dict(N_samples=64, N_samples_eval=128, N_samples_extra=32, max_total_iters=5,
                        intersection="cube", machinery="pallas" if kernels else "jnp",
                        machinery_dtype=dtype), **(sampler or {})},
        compute_dtype=dtype,
        mixed_precision=dtype != "float32",
        sampler_backend="pallas" if kernels else "jnp",
        diff_backend="pallas" if kernels else "jnp",
        rgb_backend="fused" if kernels else "jnp",
    )
    kw.update(overrides)
    return kw


def configs(kernels: bool, dtype: str = "float32", sampler=None, rendering=None, **overrides):
    """(JAX MonoSDFConfig, port MonoSDFConfig) with the same fields;
    ``sampler`` and ``rendering`` override SamplerConfig and
    RenderingNetConfig fields."""
    kw = model_kwargs(kernels, dtype, sampler, **overrides)

    def build(fields, sampler, monosdf, hashgrid):
        return monosdf.MonoSDFConfig(
            implicit=fields.ImplicitNetConfig(**IMPLICIT),
            rendering=fields.RenderingNetConfig(**{**RENDERING, **(rendering or {})}),
            sampler=sampler.SamplerConfig(**kw["sampler"]),
            **{k: v for k, v in kw.items() if k != "sampler"},
        )

    return build(jf, js, jm, jh), build(tf, ts, tm, th)


def grid_configs(kernels: bool, dtype: str = "float32", sampler=None, grid=None):
    """(JAX, port) MonoSDFConfig of a tiny hash-grid model (GRID,
    GRID_IMPLICIT, GRID_RENDERING; ``grid`` overrides HashGridConfig
    fields), the sweeps reading its first 2 levels, the radiance MLP on the
    plain path (rgb_backend 'jnp', as bench.py --grids)."""
    kw = model_kwargs(kernels, dtype, sampler, rgb_backend="jnp", sweep_max_level=2)
    gkw = {**GRID, "table_dtype": dtype, **(grid or {})}

    def build(fields, sampler, monosdf, hashgrid):
        return monosdf.MonoSDFConfig(
            implicit=fields.ImplicitNetConfig(**GRID_IMPLICIT, grid=hashgrid.HashGridConfig(**gkw)),
            rendering=fields.RenderingNetConfig(**GRID_RENDERING),
            sampler=sampler.SamplerConfig(**kw["sampler"]),
            **{k: v for k, v in kw.items() if k != "sampler"},
        )

    return build(jf, js, jm, jh), build(tf, ts, tm, th)


@functools.lru_cache(maxsize=None)
def _init_tree(implicit, rendering, seed: int, noise: float) -> dict:
    tcfg = tm.MonoSDFConfig(implicit=implicit, rendering=rendering)
    tree = params_to_tree(tm.init_monosdf(tcfg, seed=seed, device="cpu"))
    rng = np.random.default_rng(seed + 100)
    out = jax.tree_util.tree_map(
        lambda a: (a + noise * rng.standard_normal(a.shape)).astype(np.float32), tree
    )
    out["density"]["beta"] = np.asarray(0.1, np.float32)
    return out


def perturbed_tree(tcfg, seed: int = 0, noise: float = 0.05) -> dict:
    """A parameter tree as numpy (the port's geometric init, which has the
    JAX init's layout and distribution), every array perturbed by seeded
    normal noise so that the PE channels the init zeroes take part too. The
    parameters depend only on the two networks."""
    tree = _init_tree(tcfg.implicit, tcfg.rendering, seed, noise)
    return jax.tree_util.tree_map(np.copy, tree)


def both_models(jcfg, tcfg, seed: int = 0, noise: float = 0.05):
    """(JAX params pytree, port MonoSDF on the CPU) holding the same values."""
    tree = perturbed_tree(tcfg, seed, noise)
    model = load_jax_params(tm.init_monosdf(tcfg, device="cpu"), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), model, tree


def ray_batch(n: int, seed: int = 0) -> dict:
    """n rays from the synthetic scene (numpy)."""
    from monosdf_tpu.data.synthetic import make_synthetic_sphere_scene, sample_ray_batch

    scene = make_synthetic_sphere_scene(n_images=2, img_res=8)
    return sample_ray_batch(scene, np.random.default_rng(seed), n)["rays"]


def jax_draws(key, R: int, cfg) -> dict:
    """The random draws of monosdf_tpu render_rays(training=True) under
    ``key`` (monosdf.py:135, :219-226; sampler.py:373, :129, :337, :352,
    :434), as numpy, under the names the port takes them."""
    k_sampler, k_uni, k_nei = jax.random.split(key, 3)
    k_init, k_final, k_extra, k_eik = jax.random.split(k_sampler, 4)
    sc = cfg.sampler
    n_buf = sc.N_samples_eval * sc.max_total_iters
    bs = cfg.scene_bounding_sphere
    d = {
        "t_rand": jax.random.uniform(k_init, (R, sc.N_samples_eval), dtype=jnp.float32),
        "u_final": jax.random.uniform(k_final, (R, sc.N_samples), dtype=jnp.float32),
        "extra_idx": jax.random.permutation(k_extra, n_buf)[: sc.N_samples_extra],
        "eik_idx": jax.random.randint(k_eik, (R, 1), 0, sc.N_samples + sc.N_samples_extra + 2),
        "eik_uniform": jax.random.uniform(k_uni, (R, 3), minval=-bs, maxval=bs,
                                          dtype=jnp.float32),
        "eik_neigh": jax.random.uniform(k_nei, (2 * R, 3), dtype=jnp.float32),
    }
    return {k: np.array(v) for k, v in d.items()}


def torch_draws(d: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in d.items()}

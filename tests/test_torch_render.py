"""Parity of the port's eval render path with the JAX package.

The same rays and parameters (JAX init + seeded noise, carried by the weight
bridge) go through ``monosdf_tpu`` ``render_rays(training=False)`` and the
port's. With the kernel backends the JAX side runs its Pallas kernels in
interpret mode and the port runs each kernel's plain version (CPU tensors).
Tolerance 1e-4 on whole-render outputs in float32; bf16 is stated below.
The sampler runs 2 of its 5 iterations here (an upsampling one and the
last one; the others take the same code) to keep the JAX compile short.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.models.monosdf as jm
import monosdf_torch.models.monosdf as tm
from monosdf_torch.cli import eval as teval
from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
from torch_parity import both_models, configs, jit_ref, ray_batch

torch.set_num_threads(2)  # leave the cores to the other test workers

OUT_KEYS = ("rgb_values", "depth_values", "normal_map")
SAMPLE_KEYS = ("z_vals", "weights", "sdf")
ITERS = {"max_total_iters": 2}


@functools.lru_cache(maxsize=None)
def _setup(kernels, dtype):
    """(jitted JAX render, JAX params, port model, port config); ``kernels``
    "pe": the kernel backends with the sweeps' embedding inside the kernel
    (sweep_pe_in_kernel)."""
    pe = {"sweep_pe_in_kernel": True} if kernels == "pe" else {}
    jcfg, tcfg = configs(bool(kernels), dtype, sampler=ITERS, **pe)
    jparams, model, _ = both_models(jcfg, tcfg)

    @jit_ref
    def jrender(r):
        return jm.render_rays(jparams, jcfg, r, jax.random.PRNGKey(0), training=False)

    return jrender, model, tcfg


def _render_both(kernels, dtype="float32", n_rays=8):
    jrender, model, tcfg = _setup(kernels, dtype)
    rays = ray_batch(n_rays)
    jout = jrender({k: jnp.asarray(v) for k, v in rays.items()})
    tout = tm.render_rays(model, tcfg, {k: torch.from_numpy(v) for k, v in rays.items()})
    keys = OUT_KEYS + SAMPLE_KEYS
    return {k: np.asarray(jout[k]) for k in keys}, {k: tout[k].numpy() for k in keys}


@pytest.mark.parametrize("kernels", [True, False, "pe"], ids=["pallas", "jnp", "pallas-pe"])
def test_render_rays_f32_matches_jax(kernels):
    j, t = _render_both(kernels)
    for k in OUT_KEYS:
        assert t[k].shape == j[k].shape, k
        np.testing.assert_allclose(t[k], j[k], atol=1e-4, rtol=1e-4, err_msg=k)
    # Behind the surface the pdf is ~add_tiny and the CDF flat, so a sample
    # drawn there moves by (float32 rounding of the cdf) / pdf: ~2e-4 on one
    # of 784 samples here, at weight ~0, while the rendered outputs above
    # agree to ~1e-6.
    for k in SAMPLE_KEYS:
        np.testing.assert_allclose(t[k], j[k], atol=1e-3, err_msg=k)


def test_render_rays_bf16_matches_jax():
    # bf16 sweeps and operands round at the same points in both packages,
    # but float32 sums run in another order, so a rounding can land on the
    # other side of a bf16 step; sample positions then move by up to a
    # bf16 ulp of the SDF. 2e-2 on colours (in [0,1]) and depth bounds that.
    j, t = _render_both(True, "bfloat16")
    for k in ("rgb_values", "depth_values", "normal_map"):
        np.testing.assert_allclose(t[k], j[k], atol=2e-2, err_msg=k)


def test_eval_render_tiny_scene_matches_jax():
    """cli/eval.py's chunked render of a whole view against JAX's
    chunked_apply of render_rays, and the PSNR it reports."""
    from monosdf_tpu.eval.metrics import psnr as jpsnr

    jrender, model, tcfg = _setup(True, "float32")
    scene = make_synthetic_sphere_scene(n_images=1, img_res=4)
    frames = teval.scene_frames(scene, "cpu")
    rows, renders = teval.evaluate(model, tcfg, frames, split_n_pixels=8)

    n = 16
    rgb = np.concatenate([
        np.asarray(jrender({k: jnp.asarray(scene[k][i:i + 8]) for k in
                            ("rays_o", "rays_d", "depth_scale", "pose")})["rgb_values"])
        for i in range(0, n, 8)
    ])
    np.testing.assert_allclose(renders[0]["rgb_values"].numpy(), np.asarray(rgb), atol=1e-4)
    assert renders[0]["depth_values"].shape == (n, 1)
    assert abs(rows[0][1] - jpsnr(np.asarray(rgb), scene["rgb"][:n])) < 1e-2


def test_eval_cli_writes_psnr_csv(tmp_path):
    rows = teval.main(["--device", "cpu", "--n_images", "1", "--img_res", "4",
                       "--split_n_pixels", "16", "--out_dir", str(tmp_path)])
    lines = (tmp_path / "psnr.csv").read_text().splitlines()
    assert lines[0] == "frame,psnr" and lines[-1].startswith("mean,")
    assert len(rows) == 1 and np.isfinite(rows[0][1])


def test_render_samples_at_the_drawn_samples_is_render_rays():
    """render_rays is the sampler followed by render_samples; given the
    z_vals that render_rays drew, render_samples renders the same values."""
    _, model, tcfg = _setup(True, "float32")
    rays = {k: torch.from_numpy(v) for k, v in ray_batch(8, seed=3).items()}
    a = tm.render_rays(model, tcfg, rays)
    b = tm.render_samples(model, tcfg, rays, a["z_vals"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kernels", [True, False], ids=["pallas", "jnp"])
def test_training_mode_returns_the_eikonal_gradients(kernels):
    """render_rays(training=True) draws from the generator, keeps the graph
    and adds grad_theta / grad_theta_nei: (2R, 3) each, the eikonal points'
    and their neighbours' SDF gradients."""
    _, tcfg = configs(kernels, sampler=ITERS)
    model = tm.init_monosdf(tcfg, device="cpu")
    rays = {k: torch.from_numpy(v) for k, v in ray_batch(4).items()}
    out = tm.render_rays(model, tcfg, rays, training=True,
                         generator=torch.Generator().manual_seed(0))
    S = tcfg.sampler.total_samples
    assert out["grad_theta"].shape == out["grad_theta_nei"].shape == (8, 3)
    assert out["z_vals"].shape == (4, S) and out["rgb_values"].requires_grad
    assert out["grad_theta"].requires_grad and torch.isfinite(out["grad_theta"]).all()
    # the neighbours lie within 0.005 per axis of their points: the gradients are close
    assert (out["grad_theta"] - out["grad_theta_nei"]).abs().max() < 0.5


def test_kernel_and_plain_backends_differ_only_in_radiance_input(monkeypatch):
    """The JAX package's fused radiance kernel feeds the normalised gradient
    to the radiance MLP, its jnp path the raw gradient (as the reference
    network does); the port keeps both. With that input normalised, the
    plain path renders what the kernel path renders."""
    import copy

    import monosdf_torch.models.fields as tf

    _, model, tcfg_k = _setup(True, "float32")
    _, _, tcfg_p = _setup(False, "float32")
    model = copy.deepcopy(model)
    with torch.no_grad():
        for p in model.implicit.parameters():
            p.mul_(1.3)  # |grad sdf| away from 1
    rays = {k: torch.from_numpy(v) for k, v in ray_batch(8, seed=5).items()}
    a = tm.render_rays(model, tcfg_k, rays)
    b = tm.render_rays(model, tcfg_p, rays)
    gap = (a["rgb_values"] - b["rgb_values"]).abs().max().item()
    raw = tf.rendering_apply

    def normalised_input(params, cfg, points, normals, *args, **kw):
        sq = torch.sum(normals * normals, dim=-1, keepdim=True)
        return raw(params, cfg, points, normals / (torch.sqrt(sq.clamp(min=1e-24)) + 1e-6),
                   *args, **kw)

    monkeypatch.setattr(tm, "rendering_apply", normalised_input)
    c = tm.render_rays(model, tcfg_p, rays)
    for k in OUT_KEYS:
        np.testing.assert_allclose(c[k].numpy(), a[k].numpy(), atol=1e-5, err_msg=k)
    assert gap > 1e-4

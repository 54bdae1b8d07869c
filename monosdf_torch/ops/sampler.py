"""Error-bounded sampler (monosdf_tpu/ops/sampler.py).

VolSDF Algorithm 1 statically unrolled for ``max_total_iters`` rounds: SDF
sweeps over ``N_samples_eval`` new points per round, merged with the cached
values by one sort; beta bisection, error bound and the next pdf per round
(``kernels/sampler_machinery.py``, K4 with ``machinery='pallas'``, its
plain version at float32 with ``'jnp'``); a final inverse-CDF draw, the
near/far and extra samples, and a last sort. Eval mode draws with
``linspace`` only. With ``inverse_sphere_bg`` (NeRF++'s background, carried
from VolSDF; no shipped conf sets it) the extra samples' far is the ray's
exit from the scene sphere, and ``inverse_sphere_bg_z_vals`` gives the
background's samples.

Training mode draws at random, as the JAX function does: the stratified
jitter of the uniform init (``t_rand``, (R, N_samples_eval) in [0, 1)), the
final inverse-CDF draw (``u_final``, (R, N_samples)), the pick of the extra
samples (``extra_idx``, the first N_samples_extra of a permutation of the
merged buffer) and one existing sample per ray for the eikonal points
(``eik_idx``, (R, 1)). Each can be passed in ``draws``, so tests can feed
the JAX draws; the rest come from ``generator`` (on the rays' device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels.sampler_machinery import (
    sampler_iter_machinery,
    sampler_iter_machinery_plain,
)
from .density import laplace_density
from .geometry import get_sphere_intersections, near_far_from_cube


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    scene_bounding_sphere: float = 1.1
    near: float = 0.0
    far: float = -1.0  # -1 -> 2 * R * 1.75
    N_samples: int = 64
    N_samples_eval: int = 128
    N_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    add_tiny: float = 1.0e-6
    # how the uniform init finds `far`: 'cube', 'sphere' or 'none'
    intersection: str = "cube"
    # NeRF++ background: the final tail's far is the scene sphere's exit, and
    # inverse_sphere_bg_z_vals draws N_samples_inverse_sphere background samples
    inverse_sphere_bg: bool = False
    N_samples_inverse_sphere: int = 0
    # 'pallas': K4 at machinery_dtype; 'jnp': its plain version at float32
    machinery: str = "jnp"
    machinery_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.machinery not in ("jnp", "pallas"):
            raise ValueError(
                f"unknown sampler machinery {self.machinery!r}; valid: 'jnp', 'pallas' "
                "('pallas_fused' was measured-rejected and removed)"
            )

    @property
    def far_value(self) -> float:
        return 2.0 * self.scene_bounding_sphere * 1.75 if self.far < 0 else self.far

    @property
    def total_samples(self) -> int:
        return self.N_samples + self.N_samples_extra + 2


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 linspace with the values jnp.linspace gives: start * (1 - t)
    + stop * t with t = i * (1/div) (XLA turns jnp's division by the
    constant div into a product with its float32 reciprocal), endpoint
    appended."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    recip = float(np.float32(1.0) / np.float32(div))
    step = torch.arange(div, dtype=torch.float32, device=device) * recip
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def uniform_z_vals(rays_o, rays_d, cfg: SamplerConfig, n_samples: int, t_rand=None):
    """Uniform samples in [near, far], stratified-jittered by ``t_rand`` (R,
    n_samples) in [0, 1) when given (training). Returns (z, near, far)."""
    R = rays_o.shape[0]
    near = torch.full((R, 1), cfg.near, dtype=rays_o.dtype, device=rays_o.device)
    if cfg.intersection == "cube":
        _, far = near_far_from_cube(rays_o, rays_d, bound=cfg.scene_bounding_sphere,
                                    min_near=cfg.near, max_far=cfg.far_value)
    elif cfg.intersection == "sphere":
        far = get_sphere_intersections(rays_o, rays_d, r=cfg.scene_bounding_sphere)[:, 1:]
    else:
        far = torch.full((R, 1), cfg.far_value, dtype=rays_o.dtype, device=rays_o.device)
    t_vals = linspace(0.0, 1.0, n_samples, device=rays_o.device)
    z_vals = near * (1.0 - t_vals) + far * t_vals
    if t_rand is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals, near, far


def _sample_pdf(bins: torch.Tensor, pdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: bins (R,N) sorted, pdf (R,N-1), u (R,M) in [0,1].
    searchsorted(right=True) finds the interval the one-hot form of the JAX
    package finds, including its ``denom < 1e-5`` rule."""
    N = bins.shape[1]
    pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()
    below = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1, min=0)
    above = torch.clamp(below + 1, max=N - 1)
    cdf_g0, cdf_g1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_g0, bins_g1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def _d_star(z_vals: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-interval distance lower bound d* (VolSDF Theorem 1): (R,N-1)."""
    a = z_vals[:, 1:] - z_vals[:, :-1]
    b = torch.abs(d[:, :-1])
    c = torch.abs(d[:, 1:])
    first_cond = a**2 + b**2 <= c**2
    second_cond = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    area_sq = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    heron_ok = b + c - a > 0
    zero = torch.zeros_like(a)
    heron = torch.where(heron_ok, 2.0 * torch.sqrt(area_sq) / torch.clamp(a, min=1e-12), zero)
    d_star = torch.where(first_cond, b, torch.where(second_cond, c, heron))
    same_sign = torch.sign(d[:, 1:]) * torch.sign(d[:, :-1]) == 1
    return torch.where(same_sign, d_star, zero)


def _error_bound(beta, sdf, z_vals, dists, d_star):
    """Max per-ray opacity error bound (R,) (monosdf_tpu sampler._error_bound)."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(density[:, :1]), dists * density[:, :-1]], dim=-1)
    integral_estimation = torch.cumsum(shifted, dim=-1)
    error_per_section = torch.exp(-d_star / beta) * dists**2 / (4.0 * beta**2)
    error_integral = torch.cumsum(error_per_section, dim=-1)
    bound_opacity = (torch.clamp(torch.exp(error_integral), max=1.0e6) - 1.0) * torch.exp(
        -integral_estimation[:, :-1]
    )
    return torch.amax(bound_opacity, dim=-1)


def _merge_sorted_sort(z_old, s_old, z_new, s_new):
    """Sorted merge of two (z, sdf) sets: one sort with the SDF gathered."""
    z = torch.cat([z_old, z_new], dim=-1)
    s = torch.cat([s_old, s_new], dim=-1)
    z, order = torch.sort(z, dim=-1)
    return z, torch.gather(s, 1, order)


def extra_sample_indices(n_buf: int, n_extra: int, device=None) -> torch.Tensor:
    """Eval's pick of extra samples: linspace(0, n_buf-1, n_extra) truncated."""
    return linspace(0.0, float(n_buf - 1), n_extra, device=device).to(torch.int64)


def _final_tail(z_vals, samples, rays_o, rays_d, cfg: SamplerConfig, extra_idx=None):
    """near/far + N_samples_extra picked from the merged buffer (at
    ``extra_idx`` when given, else eval's linspace pick), final sort. With
    ``inverse_sphere_bg`` the far is where the ray exits the scene sphere."""
    R = rays_o.shape[0]
    kw = {"dtype": rays_o.dtype, "device": rays_o.device}
    if cfg.inverse_sphere_bg:
        far = get_sphere_intersections(rays_o, rays_d, r=cfg.scene_bounding_sphere)[:, 1:]
    else:
        far = torch.full((R, 1), cfg.far_value, **kw)
    parts = [torch.full((R, 1), cfg.near, **kw), far]
    if cfg.N_samples_extra > 0:
        if extra_idx is None:
            extra_idx = extra_sample_indices(z_vals.shape[1], cfg.N_samples_extra, rays_o.device)
        parts.append(z_vals[:, extra_idx])
    z_final, _ = torch.sort(torch.cat([samples, *parts], dim=-1), dim=-1)
    return z_final


def training_draws(R: int, cfg: SamplerConfig, draws=None, generator=None, device=None) -> dict:
    """The sampler's training draws: those given in ``draws``, the rest from
    ``generator`` (see the module docstring for names and shapes)."""
    draws = dict(draws or {})
    n_buf = cfg.N_samples_eval * cfg.max_total_iters
    kw = {"generator": generator, "device": device}
    if "t_rand" not in draws:
        draws["t_rand"] = torch.rand(R, cfg.N_samples_eval, **kw)
    if "u_final" not in draws:
        draws["u_final"] = torch.rand(R, cfg.N_samples, **kw)
    if "extra_idx" not in draws:
        draws["extra_idx"] = torch.randperm(n_buf, **kw)[:cfg.N_samples_extra]
    if "eik_idx" not in draws:
        draws["eik_idx"] = torch.randint(0, cfg.total_samples, (R, 1), **kw)
    return draws


@torch.no_grad()
def error_bound_z_vals(sdf_fn: Callable, rays_o, rays_d, beta0, cfg: SamplerConfig,
                       training: bool = False, draws=None, generator=None):
    """VolSDF error-bounded sampling. sdf_fn: (..., 3) -> (...). rays_o,
    rays_d (R, 3); beta0 a 0-d tensor. Returns z_vals (R, N_samples +
    N_samples_extra + 2), sorted; in training mode (z_vals, z_eik (R, 1)),
    drawn with ``draws`` and ``generator`` (``training_draws``)."""
    R = rays_o.shape[0]
    dev = rays_o.device
    beta0 = torch.as_tensor(beta0, dtype=rays_o.dtype, device=dev)

    def eval_sdf(z):
        return sdf_fn(rays_o[:, None, :] + z[..., None] * rays_d[:, None, :])

    if training:
        draws = training_draws(R, cfg, draws, generator, dev)
    z_vals, _, _ = uniform_z_vals(rays_o, rays_d, cfg, cfg.N_samples_eval,
                                  draws["t_rand"] if training else None)
    sdf = eval_sdf(z_vals)

    # beta upper bound from Lemma 2
    dists0 = z_vals[:, 1:] - z_vals[:, :-1]
    eps1 = torch.tensor(cfg.eps + 1.0, dtype=rays_o.dtype, device=dev)
    bound = (1.0 / (4.0 * torch.log(eps1))) * torch.sum(dists0**2, dim=-1)
    beta = torch.sqrt(bound)

    if cfg.machinery == "pallas":
        machinery, mdtype = sampler_iter_machinery, getattr(torch, cfg.machinery_dtype)
        mdtype = None if mdtype == torch.float32 else mdtype
    else:
        machinery, mdtype = sampler_iter_machinery_plain, None
    samples = z_vals
    for it in range(cfg.max_total_iters):
        last = it == cfg.max_total_iters - 1
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        dists_tail = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
        d_star = torch.nn.functional.pad(_d_star(z_vals, sdf), (0, 1))
        beta_col, pdf_full = machinery(
            sdf.contiguous(), dists_tail.contiguous(), d_star.contiguous(),
            beta[:, None].contiguous(), beta0, eps=cfg.eps, add_tiny=cfg.add_tiny, last=last,
            beta_iters=cfg.beta_iters, dtype=mdtype,
        )
        beta = beta_col[:, 0]
        pdf = pdf_full[:, :-1]
        n_draw = cfg.N_samples if last else cfg.N_samples_eval
        if last and training:
            u = draws["u_final"]
        else:
            u = linspace(0.0, 1.0, n_draw, device=dev)[None].expand(R, n_draw)
        new_z = _sample_pdf(z_vals, pdf, u)
        if last:
            samples = new_z
        else:
            z_vals, sdf = _merge_sorted_sort(z_vals, sdf, new_z, eval_sdf(new_z))
    if not training:
        return _final_tail(z_vals, samples, rays_o, rays_d, cfg)
    z_final = _final_tail(z_vals, samples, rays_o, rays_d, cfg, draws["extra_idx"])
    return z_final, torch.gather(z_final, 1, draws["eik_idx"])


def inverse_sphere_bg_z_vals(rays_o, rays_d, cfg: SamplerConfig, training: bool, u=None,
                             generator=None) -> torch.Tensor:
    """NeRF++ background samples in inverted-sphere space
    (monosdf_tpu/ops/sampler.py ``inverse_sphere_bg_z_vals``): a linspace on
    [0, 1] (the 1/r parameter of the outer volume), stratified-jittered in
    training by the uniforms ``u`` (R, N_samples_inverse_sphere) in [0, 1),
    drawn from ``generator`` when not given, scaled by
    1/scene_bounding_sphere. Returns (R, N_samples_inverse_sphere)."""
    R = rays_o.shape[0]
    n = cfg.N_samples_inverse_sphere
    z = linspace(0.0, 1.0, n, device=rays_o.device)[None].expand(R, n).to(rays_o.dtype)
    if training:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        if u is None:
            u = torch.rand(R, n, generator=generator, device=rays_o.device, dtype=rays_o.dtype)
        z = lower + (upper - lower) * u
    return (z * (1.0 / cfg.scene_bounding_sphere)).detach()

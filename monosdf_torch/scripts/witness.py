"""Float64 witnesses of the render path's four forward kernels.

Each function computes its kernel's function (the plain version's, in
``monosdf_torch/kernels``) with every sum, product and transcendental in
float64, its operands rounded to bf16 where the kernel rounds them (for
``dtype`` bf16), and rounds each output once to the kernel's output dtype.
On float32 inputs they return float32, as the kernels do, so that a render
can run with them in the kernels' places; on float64 inputs they return
float64 (the CPU tests hold them so to the JAX package's float64 paths).

- ``k1_float64``: K1, the sampler's no-grad SDF sweeps (``sdf_mlp_plain``);
- ``k4_float64``: K4, one iteration of the sampler's machinery: the beta
  bisection, the error bound and the pdf (``sampler_iter_machinery_plain``);
- ``k2f_float64``: K2f, the SDF, features and spatial gradient of the
  render's samples (``sdf_mlp_with_grad_plain``);
- ``k3f_float64``: K3f, the radiance MLP with the normalisation
  (``radiance_norm_plain``).

A render with all four in the kernels' places is the witness that
``chip_smoke.py`` holds the kernel render and the plain render to: which of
the two lies nearer the float64 truth, at the same samples and through the
sampler.
"""

from __future__ import annotations

import math

import torch

from ..kernels.sampler_machinery import _laplace
from ..kernels.sdf_mlp import softplus100


def _rounded64(dtype):
    """A float64 copy of a tensor, first rounded to ``dtype`` (bf16) where
    the kernels round it; float32: as it is."""
    return (lambda t: t.to(dtype).double()) if dtype is not None else (lambda t: t.double())


def _out(t: torch.Tensor, dtype, like: torch.dtype) -> torch.Tensor:
    """t rounded once to the kernel's output dtype (bf16 where it emits
    bf16), held at the caller's dtype ``like``."""
    return t.to(dtype).to(like) if dtype is not None else t.to(like)


def k1_float64(ws, bs, x, skip_in, dtype=None, packed=None) -> torch.Tensor:
    """K1 (``sdf_mlp_plain``) in float64: the input rounded to ``dtype`` as
    K1 reads it, each layer's operands rounded to ``dtype``, the sums, biases
    and softplus in float64; the output rounded to ``dtype`` (bf16) as K1
    emits it. ``packed`` (K1's packed weights) is accepted and unused, so
    that the function can stand at the sweeps' call site."""
    r = _rounded64(dtype)
    x0 = r(x)
    h = x0
    L = len(ws)
    for l in range(L):
        if l in skip_in:
            h = torch.cat([h, x0], dim=-1) / math.sqrt(2.0)
        acc = r(h) @ r(ws[l]) + bs[l].double()
        h = softplus100(acc) if l < L - 1 else acc
    return _out(h, dtype, x.dtype if x.dtype == torch.float64 else torch.float32)


def k4_float64(sdf, dists_tail, d_star, beta_prev, beta0, eps: float, add_tiny: float,
               last: bool, beta_iters: int = 10, dtype=None):
    """K4 (``sampler_iter_machinery_plain``) in float64: (beta (R, 1), pdf
    (R, N)). The scanned terms are rounded to ``dtype`` (bf16) where the
    kernel rounds them; the bisection, the error bounds, the exponentials and
    the cumulative sums run in float64. Outputs at sdf's dtype."""
    like = sdf.dtype
    r = _rounded64(dtype)
    sdf, dists_tail, d_star, beta_prev = (t.double() for t in (sdf, dists_tail, d_star,
                                                               beta_prev))
    N = sdf.shape[1]
    interior = (torch.arange(N, device=sdf.device) < N - 1).double()
    dists = dists_tail * interior

    def exclusive(v):
        c = torch.cumsum(v, dim=1)
        return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)

    def section_error(beta):
        return r(torch.exp(-d_star / beta) * (dists * dists) / (4.0 * beta * beta))

    def error_bound(beta):
        integral = exclusive(r(dists * _laplace(sdf, beta)))
        err_int = torch.cumsum(section_error(beta), dim=1)
        bound = (torch.clamp(torch.exp(err_int), max=1.0e6) - 1.0) * torch.exp(-integral)
        return torch.amax(bound * interior, dim=1, keepdim=True)

    b0 = torch.as_tensor(beta0, device=sdf.device).reshape(1, 1).double()
    curr = error_bound(b0)
    bmax = torch.where(curr <= eps, b0, beta_prev)
    bmin = b0.expand_as(bmax)
    for _ in range(beta_iters):
        bmid = 0.5 * (bmin + bmax)
        ok = error_bound(bmid) <= eps
        bmax = torch.where(ok, bmid, bmax)
        bmin = torch.where(ok, bmin, bmid)
    beta = bmax

    fe_tail = dists_tail * _laplace(sdf, beta)
    trans = torch.exp(-exclusive(r(fe_tail)))
    if last:
        pdf = (1.0 - torch.exp(-fe_tail)) * trans + 1e-5
    else:
        err_int = torch.cumsum(section_error(beta), dim=1)
        pdf = (torch.clamp(torch.exp(err_int), max=1.0e6) - 1.0) * trans + add_tiny
    return beta.to(like), (pdf * interior).to(like)


def k2f_float64(ws, bs, x, multires, skip_in, dtype, bounding_sphere, sphere_scale,
                clamp_rows, save_z):
    """K2f's function (kernels/sdf_grad.py sdf_mlp_with_grad_plain) with the
    PE and every sum in float64, operands rounded at the kernel's bf16
    rounding points, on the kernel's float32 inputs; each output rounded once
    to the kernel's output dtype."""
    from ..kernels.sdf_grad import clamp_to_sphere, gate100, pe_with_tangents

    assert not save_z, "the render path's call"
    r = _rounded64(dtype)
    N, x64 = x.shape[0], x.double()
    emb, tang = pe_with_tangents(x64, multires)
    A0 = A = torch.cat([emb, tang], dim=0)
    for l in range(len(ws) - 1):
        if l in skip_in:
            A = torch.cat([A, A0], dim=-1) / math.sqrt(2.0)
        Z = r(A) @ r(ws[l])
        h, sg = gate100(Z[:N] + bs[l].double())
        A = torch.cat([h, sg.repeat(3, 1) * Z[N:]], dim=0)
    if (len(ws) - 1) in skip_in:
        A = torch.cat([A, A0], dim=-1) / math.sqrt(2.0)
    Zp = r(A[:N]) @ r(ws[-1]) + bs[-1].double()
    grad = (r(A[N:]) @ r(ws[-1][:, :1])).reshape(3, N).T
    sdf = Zp[:, :1]
    if bounding_sphere > 0.0:
        sdf, grad, _ = clamp_to_sphere(sdf, grad, x64, bounding_sphere, sphere_scale, clamp_rows)
    return sdf.float(), Zp[:, 1:].to(dtype or torch.float32), grad.float().contiguous()


def k3f_float64(ws, bs, g, sv, feat, dtype=None, code=None):
    """K3f's function (kernels/radiance_norm.py radiance_norm_plain) with
    every sum in float64, operands and bf16 pre-activations rounded where the
    kernel rounds them; outputs rounded once to float32."""
    from ..kernels.radiance_norm import normalize

    r = _rounded64(dtype)
    n = normalize(g.double())
    h = torch.cat([sv.double(), n, feat.double()]
                  + ([code.double()] if code is not None else []), dim=-1)
    for l in range(len(ws) - 1):
        acc = r(h) @ r(ws[l])
        h = torch.relu(r(r(acc) + r(bs[l])) if dtype is not None else acc + bs[l].double())
    return (r(h) @ r(ws[-1]) + bs[-1].double()).float(), n.float()

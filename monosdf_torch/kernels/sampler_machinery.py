"""K4: one iteration of the error-bounded sampler's machinery.

Replaces ``monosdf_tpu/ops/pallas_sampler.py sampler_iter_machinery`` (its
``pl.pallas_call`` at :147), reached from ``ops/sampler.py`` once per
sampler iteration. Kernel: ``csrc/sampler_machinery.cu``.

Per ray row: the error bound at beta0, ``beta_iters`` bisection steps of
beta against ``eps`` (11 error bounds in all), then the Laplace density,
transmittance and the next draw's pdf (``bound + add_tiny``, or
``weights + 1e-5`` when ``last``), with lane N-1 of the pdf zero.

Bound on the card: the error bounds' arithmetic in series. The bytes
(three (R, N) float32 arrays read, one written) and the exp and divisions
take ~10 us at the card's rates, but a ray's 11 error bounds run one after
another. The TPU ran each cumsum as an (N, N) triangular 0/1 matmul; here
one warp owns a row, each lane a run of N/32 samples, and a cumsum is a
lane-local running sum plus one shuffle scan. The kernel bisects
speculatively: a block of 4 warps per ray evaluates the 3 midpoints of the
next 2 bisection steps at once (the first round also the bound at beta0),
so a ray takes 5 rounds, and each warp's error bound is the sequential
kernel's, so beta and the pdf keep its bits (its divisions take div.rn's
fast path with one reciprocal per error bound where that gives div.rn's
bits). ``sampler_iter_machinery_seq`` launches the same kernel at depth 1,
the sequential loop with div.rn throughout: the order reference of the
card tests, counted in ``build.reference_launches`` (no main path launches
it).

Its plain version below is also the port's ``machinery='jnp'`` path (at
float32), as ``ops/sampler.py`` selects it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nn import round_to
from . import build

NAME = "sampler_machinery"
REFERENCE = "sampler_machinery_seq"  # its depth-1 launches, in build.reference_launches
_c = ctypes.c_void_p


def _laplace(s: torch.Tensor, beta) -> torch.Tensor:
    # (0.5 + 0.5 sign(s) expm1(-|s|/beta)) / beta, written branchless
    e = torch.exp(-torch.abs(s) / beta)
    return torch.where(s > 0.0, 0.5 * e, 1.0 - 0.5 * e) / beta


def sampler_iter_machinery_plain(sdf, dists_tail, d_star, beta_prev, beta0, eps: float,
                                 add_tiny: float, last: bool, beta_iters: int = 10,
                                 dtype=None):
    """The kernel's function in plain PyTorch: (beta (R, 1), pdf (R, N))."""
    N = sdf.shape[1]
    interior = (torch.arange(N, device=sdf.device) < N - 1).float()
    dists = dists_tail * interior

    def exclusive(v):
        c = torch.cumsum(v, dim=1)
        return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)

    def section_error(beta):
        return round_to(torch.exp(-d_star / beta) * (dists * dists) / (4.0 * beta * beta), dtype)

    def error_bound(beta):
        integral = exclusive(round_to(dists * _laplace(sdf, beta), dtype))
        err_int = torch.cumsum(section_error(beta), dim=1)
        bound = (torch.clamp(torch.exp(err_int), max=1.0e6) - 1.0) * torch.exp(-integral)
        return torch.amax(bound * interior, dim=1, keepdim=True)

    b0 = beta0.reshape(1, 1).float()
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
    trans = torch.exp(-exclusive(round_to(fe_tail, dtype)))
    if last:
        pdf = (1.0 - torch.exp(-fe_tail)) * trans + 1e-5
    else:
        err_int = torch.cumsum(section_error(beta), dim=1)
        pdf = (torch.clamp(torch.exp(err_int), max=1.0e6) - 1.0) * trans + add_tiny
    return beta, pdf * interior


@functools.cache
def _lib():
    lib = build.load(NAME)
    lib.sampler_machinery_launch.restype = ctypes.c_int
    lib.sampler_machinery_launch.argtypes = [
        _c, _c, _c, _c, _c, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _c, _c, ctypes.c_int, ctypes.c_int, _c,
    ]
    return lib


def _launch(sdf, dists_tail, d_star, beta_prev, beta0, eps, add_tiny, last, beta_iters, dtype,
            depth: int):
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    dev = sdf.device
    R, N = sdf.shape
    if N % 32 or N > 640:
        raise ValueError(f"N = {N}: the kernel takes a multiple of 32 up to 640")
    f32 = torch.float32
    for t, what, shape in ((sdf, "sdf", (R, N)), (dists_tail, "dists_tail", (R, N)),
                           (d_star, "d_star", (R, N)), (beta_prev, "beta_prev", (R, 1))):
        build.require(t, what, f32, shape, dev)
    b0 = beta0.reshape(1)
    build.require(b0, "beta0", f32, (1,), dev)
    beta = torch.empty(R, 1, dtype=f32, device=dev)
    pdf = torch.empty(R, N, dtype=f32, device=dev)
    if R == 0:
        return beta, pdf, False
    lib = _lib()
    err = lib.sampler_machinery_launch(
        build.ptr(sdf), build.ptr(dists_tail), build.ptr(d_star), build.ptr(beta_prev),
        build.ptr(b0), R, N, float(eps), float(add_tiny), int(last), int(beta_iters),
        build.ptr(beta), build.ptr(pdf), int(dtype is not None), depth, build.stream_ptr(dev),
    )
    build.check(lib, NAME, err)
    return beta, pdf, True


def sampler_iter_machinery(sdf, dists_tail, d_star, beta_prev, beta0, eps: float,
                           add_tiny: float, last: bool, beta_iters: int = 10, dtype=None):
    """(beta (R, 1), pdf (R, N)) for one sampler iteration.

    sdf, dists_tail (lane N-1 = 1e10), d_star (lane N-1 = 0): (R, N) float32;
    beta_prev (R, 1); beta0 a 0-d tensor. dtype None or bf16 (the cumsum
    operands). A CPU tensor takes the plain version; CUDA launches K4."""
    if sdf.device.type == "cpu":
        return sampler_iter_machinery_plain(sdf, dists_tail, d_star, beta_prev, beta0, eps,
                                            add_tiny, last, beta_iters, dtype)
    beta, pdf, launched = _launch(sdf, dists_tail, d_star, beta_prev, beta0, eps, add_tiny, last,
                                  beta_iters, dtype, 2)
    if launched:
        build.launches[NAME] += 1
    return beta, pdf


def sampler_iter_machinery_seq(sdf, dists_tail, d_star, beta_prev, beta0, eps: float,
                               add_tiny: float, last: bool, beta_iters: int = 10, dtype=None):
    """K4 at depth 1 on a CUDA tensor: the sequential bisection, one error
    bound per round, in the same kernel. The speculative kernel's order
    reference (bit for bit); no model path calls it. A CPU tensor takes the
    plain version, as the main wrapper does, and launches nothing."""
    if sdf.device.type == "cpu":
        return sampler_iter_machinery_plain(sdf, dists_tail, d_star, beta_prev, beta0, eps,
                                            add_tiny, last, beta_iters, dtype)
    beta, pdf, launched = _launch(sdf, dists_tail, d_star, beta_prev, beta0, eps, add_tiny, last,
                                  beta_iters, dtype, 1)
    if launched:
        build.reference_launches[REFERENCE] += 1
    return beta, pdf

"""The port's CUDA kernels against their plain versions, on a card.

Needs a CUDA device and nvcc; skips without a card. It imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small widths (4x48 SDF MLP with a skip at 2, multires 4; 2x48 radiance
MLP) and a few hundred points; the full-width shapes are chip_smoke.py's.
"""

import numpy as np
import pytest
import torch

from monosdf_torch.kernels import build
from monosdf_torch.kernels.radiance_norm import (
    radiance_norm,
    radiance_norm_bwd,
    radiance_norm_bwd_plain,
    radiance_norm_plain,
)
from monosdf_torch.kernels.sampler_machinery import (
    sampler_iter_machinery,
    sampler_iter_machinery_plain,
)
from monosdf_torch.kernels.sdf_grad import (
    sdf_mlp_with_grad,
    sdf_mlp_with_grad_bwd,
    sdf_mlp_with_grad_bwd_plain,
    sdf_mlp_with_grad_plain,
)
from monosdf_torch.kernels.sdf_mlp import sdf_mlp, sdf_mlp_plain
from monosdf_torch.models.fields import (
    ImplicitNetConfig,
    RenderingNetConfig,
    effective_linear_weights,
    init_implicit_net,
    init_rendering_net,
)
from monosdf_torch.ops.embedder import positional_encoding
from monosdf_torch.ops.sampler import _d_star

IMP = ImplicitNetConfig(feature_vector_size=32, dims=(48,) * 4, skip_in=(2,), multires=4)
REN = RenderingNetConfig(feature_vector_size=32, dims=(48, 48), multires_view=4)
# kernel vs plain: float32 sums in another order (and bf16 roundings that
# can land on the neighbouring value); err <= atol + rtol * max|plain|
TOL = {None: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}
# K4's pdf entry by entry, |a - b| <= atol + rtol * |b|: entries run from
# add_tiny (1e-6) to ~1e3
K4_PDF_TOL = {None: (1e-6, 1e-4), torch.bfloat16: (1e-5, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nets(dev):
    gen = torch.Generator().manual_seed(0)
    imp, ren = init_implicit_net(IMP, gen), init_rendering_net(REN, gen)
    with torch.no_grad():
        for p in [*imp.parameters(), *ren.parameters()]:
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return imp.to(dev), ren.to(dev)


def _check(outs, refs, dtype):
    atol, rtol = TOL[dtype]
    for a, b in zip(outs, refs):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a.float()).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= atol + rtol * b.float().abs().max().item(), err


def _rand(dev, *shape, lo=-1.15, hi=1.15, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_k2_k3_match_plain(dev, dtype):
    imp, ren = _nets(dev)
    before = dict(build.launches)
    with torch.no_grad():
        ws, bs = effective_linear_weights(imp)
        x = _rand(dev, 700, 3)
        emb = positional_encoding(x, IMP.multires)
        w1, b1 = ws[:-1] + [ws[-1][:, :1]], bs[:-1] + [bs[-1][:1]]
        _check([sdf_mlp(w1, b1, emb, IMP.skip_in, dtype)],
               [sdf_mlp_plain(w1, b1, emb, IMP.skip_in, dtype)], dtype)
        args = (ws, bs, x, IMP.multires, IMP.skip_in, dtype, 1.1, 1.0)
        _check(sdf_mlp_with_grad(*args), sdf_mlp_with_grad_plain(*args), dtype)
        rws, rbs = effective_linear_weights(ren)
        g = _rand(dev, 700, 3, seed=1)
        g[:5] = 0.0
        sv = torch.cat([x, positional_encoding(_rand(dev, 700, 3, seed=2), 4)], -1)
        feat = _rand(dev, 700, 32, seed=3)
        _check(radiance_norm(rws, rbs, g, sv, feat, dtype),
               radiance_norm_plain(rws, rbs, g, sv, feat, dtype), dtype)
    torch.cuda.synchronize()
    assert {k: build.launches[k] - before[k] for k in before} == {
        "sdf_mlp": 1, "sampler_machinery": 0, "sdf_grad": 1, "radiance_norm": 1,
        "sdf_grad_bwd": 0, "radiance_norm_bwd": 0}


# parameter gradients, sums over the rows: err <= atol + rtol * max|plain| per
# tensor; float32 sums in another order, bf16 operands in both
GRAD_TOL = {None: (2e-4, 1e-3), torch.bfloat16: (1e-2, 2e-2)}


def _check_grads(outs, refs, dtype):
    atol, rtol = GRAD_TOL[dtype]
    for a, b in zip(outs, refs):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= atol + rtol * b.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k2_training_forward_and_backward_match_plain(dev, dtype):
    """K2f with clamp_rows, flag and saved Z, and K2b, against their plain
    versions; 700 points (no multiple of the 16-point tile), a 0.9 sphere
    so that the clamp fires, the last 100 points unclamped."""
    imp, _ = _nets(dev)
    with torch.no_grad():
        ws, bs = effective_linear_weights(imp)
        x = _rand(dev, 700, 3, lo=-1.3, hi=1.3, seed=4)
        args = (ws, bs, x, IMP.multires, IMP.skip_in, dtype, 0.9, 1.0, 600, True)
        sdf, feat, grad, flag, zs = sdf_mlp_with_grad(*args)
        ref = sdf_mlp_with_grad_plain(*args)
        # where the take-MLP select flips (bf16: an SDF within a rounding of
        # the sphere's), sdf and grad take the other branch; compare the rest
        same = (flag == ref[3])[:, 0]
        assert int((~same).sum()) <= (0 if dtype is None else 7)
        _check([sdf[same], feat, grad[same], *zs], [ref[0][same], ref[1], ref[2][same], *ref[4]],
               dtype)
        assert 0 < int((flag[:600] == 0).sum()) and bool((flag[600:] == 1).all())
        cots = [_rand(dev, 700, k, seed=5 + k) for k in (1, 32, 3)]
        dws, dbs = sdf_mlp_with_grad_bwd(ws, bs, x, zs, *cots, IMP.multires, IMP.skip_in, dtype,
                                         flag)
        dws_p, dbs_p = sdf_mlp_with_grad_bwd_plain(ws, bs, x, zs, *cots, IMP.multires,
                                                   IMP.skip_in, dtype, flag)
        _check_grads([*dws, *dbs], [*dws_p, *dbs_p], dtype)
        again = sdf_mlp_with_grad_bwd(ws, bs, x, zs, *cots, IMP.multires, IMP.skip_in, dtype, flag)
        assert all(torch.equal(a, b) for a, b in zip([*dws, *dbs], [*again[0], *again[1]]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_backward_matches_plain(dev, dtype):
    _, ren = _nets(dev)
    with torch.no_grad():
        rws, rbs = effective_linear_weights(ren)
        g = _rand(dev, 700, 3, seed=1)
        g[:5] = 0.0
        sv = torch.cat([_rand(dev, 700, 3), positional_encoding(_rand(dev, 700, 3, seed=2), 4)], -1)
        feat = _rand(dev, 700, 32, seed=3)
        co, cn = _rand(dev, 700, 3, seed=8), _rand(dev, 700, 3, seed=9)
        dws, dbs, dg, df = radiance_norm_bwd(rws, rbs, g, sv, feat, co, cn, dtype)
        dws_p, dbs_p, dg_p, df_p = radiance_norm_bwd_plain(rws, rbs, g, sv, feat, co, cn, dtype)
        _check_grads([*dws, *dbs, dg], [*dws_p, *dbs_p, dg_p], dtype)
        _check([df], [df_p], dtype)


@pytest.mark.cuda
def test_autograd_functions_launch_the_backward_kernels(dev):
    imp, ren = _nets(dev)
    before = dict(build.launches)
    ws, bs = effective_linear_weights(imp)
    x = _rand(dev, 300, 3)
    sdf, feat, grad = sdf_mlp_with_grad(ws, bs, x, IMP.multires, IMP.skip_in, torch.bfloat16,
                                        1.1, 1.0, 250)
    rws, rbs = effective_linear_weights(ren)
    sv = torch.cat([x, positional_encoding(x, 4)], -1)
    rgb, nrm = radiance_norm(rws, rbs, grad, sv, feat, torch.bfloat16)
    (sdf.sum() + rgb.sum() + nrm.sum() + (grad**2).sum()).backward()
    torch.cuda.synchronize()
    for p in [*imp.parameters(), *ren.parameters()]:
        assert p.grad is not None and torch.isfinite(p.grad).all()
    assert {k: build.launches[k] - before[k] for k in before} == {
        "sdf_mlp": 0, "sampler_machinery": 0, "sdf_grad": 1, "radiance_norm": 1,
        "sdf_grad_bwd": 1, "radiance_norm_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [128, 640])
def test_k4_matches_plain(dev, dtype, N):
    R = 96
    rng = np.random.default_rng(N)
    z = np.sort(rng.uniform(0.0, 3.85, (R, N)), axis=-1)
    sdf = np.tanh(rng.uniform(0.8, 2.5, (R, 1)) - z) * 0.6 + 0.01 * rng.normal(size=(R, N))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    zt, st = t(z), t(sdf)
    dists = np.diff(z, axis=-1)
    dt = t(np.concatenate([dists, np.full((R, 1), 1e10)], -1))
    ds = torch.nn.functional.pad(_d_star(zt, st), (0, 1)).contiguous()
    bp = t(np.sqrt(np.sum(dists**2, -1) / (4 * np.log(1.1)))[:, None])
    b0 = torch.tensor(0.01, device=dev)
    for last in (False, True):
        (bk, pk), (bpl, ppl) = (
            fn(st, dt, ds, bp, b0, 0.1, 1e-6, last, 10, dtype)
            for fn in (sampler_iter_machinery, sampler_iter_machinery_plain)
        )
        # a flipped bisection step moves beta by one halving of [beta0, beta_prev]
        assert (bk - bpl).abs().max().item() <= bp.max().item() / 2**10
        assert torch.isfinite(pk).all()
        atol, rtol = K4_PDF_TOL[dtype]
        assert ((pk - ppl).abs() <= atol + rtol * ppl.abs()).all()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    imp, ren = _nets(dev)
    with torch.no_grad():
        ws, bs = effective_linear_weights(imp)
        x = _rand(dev, 64, 3)
        emb = positional_encoding(x, IMP.multires)
        w1, b1 = ws[:-1] + [ws[-1][:, :1]], bs[:-1] + [bs[-1][:1]]
        with pytest.raises(ValueError):  # weights on the CPU
            sdf_mlp([w.cpu() for w in w1], [b.cpu() for b in b1], emb, IMP.skip_in)
        with pytest.raises(ValueError):  # float16 operands
            sdf_mlp(w1, b1, emb, IMP.skip_in, torch.float16)
        with pytest.raises(ValueError):  # x not (N, 3) float32
            sdf_mlp_with_grad(ws, bs, x.double(), IMP.multires, IMP.skip_in)
        rws, rbs = effective_linear_weights(ren)
        sv = torch.cat([x, positional_encoding(x, 4)], -1)
        with pytest.raises(ValueError):  # sv on the CPU
            radiance_norm(rws, rbs, x, sv.cpu(), _rand(dev, 64, 32))
        s = _rand(dev, 8, 100)
        with pytest.raises(ValueError):  # N not a multiple of 32
            sampler_iter_machinery(s, s, s, s[:, :1].contiguous(), torch.tensor(0.01, device=dev),
                                   0.1, 1e-6, False)

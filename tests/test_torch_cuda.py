"""The port's CUDA kernels against their plain versions, on a card.

Needs a CUDA device and nvcc; skips without a card. It imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small widths (4x48 SDF MLP with a skip at 2, multires 4; 2x48 radiance
MLP, with codes of 8 for K3, K8a and K8b; a 6-level hash grid and a 2x48
grid trunk on its 71-wide input) and a few hundred points; the full-width
shapes are chip_smoke.py's. The conf tests run three shipped confs at full
width through cli/train.py --conf for 3 steps on 32x32 scenes.
"""

import subprocess
import sys
from pathlib import Path

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
    sampler_iter_machinery_seq,
)
from monosdf_torch.kernels.sdf_grad import (
    sdf_mlp_with_grad,
    sdf_mlp_with_grad_bwd,
    sdf_mlp_with_grad_bwd_plain,
    sdf_mlp_with_grad_plain,
)
from monosdf_torch.kernels.sdf_mlp import sdf_mlp, sdf_mlp_pe, sdf_mlp_pe_plain, sdf_mlp_plain
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
        **dict.fromkeys(before, 0), "sdf_mlp": 1, "sdf_grad": 1, "radiance_norm": 1}


# K1 on the 39-wide embedding (multires 6, as the bench's sweeps) and K1-PE on
# the raw points, and K1 on a 71-wide input (the grid trunk's [PE | 32
# features], a 2x48 trunk without skip): 700 points, and 131,072 + 5 (the
# sweep's rows and a ragged last tile; the persistent tile loop wraps)
IMP_PE = ImplicitNetConfig(feature_vector_size=32, dims=(48,) * 4, skip_in=(2,), multires=6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [700, 131072 + 5])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_and_k1_pe_match_plain_at_39_and_71_wide(dev, dtype, n):
    gen = torch.Generator().manual_seed(0)
    imp = init_implicit_net(IMP_PE, gen)
    rng = np.random.default_rng(11)
    ws71 = [torch.from_numpy((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)).to(dev)
            for a, b in ((71, 48), (48, 48), (48, 1))]
    bs71 = [torch.from_numpy((0.1 * rng.normal(size=b)).astype(np.float32)).to(dev)
            for b in (48, 48, 1)]
    before = dict(build.launches)
    with torch.no_grad():
        for p in imp.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        ws, bs = effective_linear_weights(imp.to(dev))
        w1, b1 = ws[:-1] + [ws[-1][:, :1]], bs[:-1] + [bs[-1][:1]]
        x = _rand(dev, n, 3)
        emb = positional_encoding(x, IMP_PE.multires)
        assert emb.shape[1] == 39
        _check([sdf_mlp(w1, b1, emb, IMP_PE.skip_in, dtype)],
               [sdf_mlp_plain(w1, b1, emb, IMP_PE.skip_in, dtype)], dtype)
        _check([sdf_mlp_pe(w1, b1, x, IMP_PE.multires, IMP_PE.skip_in, dtype)],
               [sdf_mlp_pe_plain(w1, b1, x, IMP_PE.multires, IMP_PE.skip_in, dtype)], dtype)
        inp = _rand(dev, n, 71, seed=12)
        _check([sdf_mlp(ws71, bs71, inp, (), dtype)], [sdf_mlp_plain(ws71, bs71, inp, (), dtype)],
               dtype)
    torch.cuda.synchronize()
    assert {k: build.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "sdf_mlp": 2, "sdf_mlp_pe": 1}


# parameter gradients, sums over the rows: err <= atol + rtol * max|plain| per
# tensor; float32 sums in another order, bf16 operands in both
GRAD_TOL = {None: (2e-4, 1e-3), torch.bfloat16: (1e-2, 2e-2)}


def _check_grads(outs, refs, dtype):
    atol, rtol = GRAD_TOL[dtype]
    for a, b in zip(outs, refs):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= atol + rtol * b.float().abs().max().item(), err


# 8,469 points: 265 tiles of the bf16 K2f's 32 points, more than the card
# has SMs (the persistent tile loop wraps), the last one ragged (21 points),
# and clamp_rows (n - 100) inside a tile, in its second warpgroup
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(None, 700), (torch.bfloat16, 700), (torch.bfloat16, 8469)],
                         ids=["f32", "bf16", "bf16-8469"])
def test_k2_training_forward_and_backward_match_plain(dev, dtype, n):
    """K2f with clamp_rows, flag and saved Z, and K2b, against their plain
    versions; 700 points (no multiple of the 16-point tile) or the 8,469
    above, a 0.9 sphere so that the clamp fires, the last 100 points
    unclamped."""
    imp, _ = _nets(dev)
    clamp = n - 100
    with torch.no_grad():
        ws, bs = effective_linear_weights(imp)
        x = _rand(dev, n, 3, lo=-1.3, hi=1.3, seed=4)
        args = (ws, bs, x, IMP.multires, IMP.skip_in, dtype, 0.9, 1.0, clamp, True)
        sdf, feat, grad, flag, zs = sdf_mlp_with_grad(*args)
        ref = sdf_mlp_with_grad_plain(*args)
        # where the take-MLP select flips (bf16: an SDF within a rounding of
        # the sphere's), sdf and grad take the other branch; compare the rest
        same = (flag == ref[3])[:, 0]
        assert int((~same).sum()) <= (0 if dtype is None else n // 100)
        _check([sdf[same], feat, grad[same], *zs], [ref[0][same], ref[1], ref[2][same], *ref[4]],
               dtype)
        assert 0 < int((flag[:clamp] == 0).sum()) and bool((flag[clamp:] == 1).all())
        cots = [_rand(dev, n, k, seed=5 + k) for k in (1, 32, 3)]
        dws, dbs = sdf_mlp_with_grad_bwd(ws, bs, x, zs, *cots, IMP.multires, IMP.skip_in, dtype,
                                         flag)
        dws_p, dbs_p = sdf_mlp_with_grad_bwd_plain(ws, bs, x, zs, *cots, IMP.multires,
                                                   IMP.skip_in, dtype, flag)
        _check_grads([*dws, *dbs], [*dws_p, *dbs_p], dtype)
        again = sdf_mlp_with_grad_bwd(ws, bs, x, zs, *cots, IMP.multires, IMP.skip_in, dtype, flag)
        assert all(torch.equal(a, b) for a, b in zip([*dws, *dbs], [*again[0], *again[1]]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k2b_matches_plain_over_more_tiles_than_sms(dev, dtype):
    """K2b at 40,000 points: 2,500 16-point tiles, more than the card has
    SMs, so the persistent tile loop wraps (and the bf16 path's pass 2
    splits its tiles); the bars and the same bits on two runs as above."""
    imp, _ = _nets(dev)
    n = 40_000
    assert n // 16 > torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.no_grad():
        ws, bs = effective_linear_weights(imp)
        x = _rand(dev, n, 3, lo=-1.3, hi=1.3, seed=4)
        args = (ws, bs, x, IMP.multires, IMP.skip_in, dtype, 0.9, 1.0, n - 100, True)
        _, _, _, flag, zs = sdf_mlp_with_grad(*args)
        cots = [_rand(dev, n, k, seed=5 + k) for k in (1, 32, 3)]
        bwd = (ws, bs, x, zs, *cots, IMP.multires, IMP.skip_in, dtype, flag)
        dws, dbs = sdf_mlp_with_grad_bwd(*bwd)
        dws_p, dbs_p = sdf_mlp_with_grad_bwd_plain(*bwd)
        _check_grads([*dws, *dbs], [*dws_p, *dbs_p], dtype)
        again = sdf_mlp_with_grad_bwd(*bwd)
        assert all(torch.equal(a, b) for a, b in zip([*dws, *dbs], [*again[0], *again[1]]))


# 40,007 rows: 626 64-row tiles of the bf16 K3b's pass 1, more than the
# card has SMs (the persistent tile loop wraps), the last one ragged (7
# rows); pass 2 splits its tiles
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,code_dim", [(None, 700, 0), (torch.bfloat16, 700, 0),
                                              (torch.bfloat16, 40007, 0),
                                              (torch.bfloat16, 40007, 8)],
                         ids=["f32", "bf16", "bf16-40007", "bf16-40007-code"])
def test_k3_backward_matches_plain(dev, dtype, n, code_dim):
    """K3b against its plain version (dg, dc and the parameter gradients at
    the gradient bars, df at the forward's); at 40,007 rows also with a
    code, the rows whose ReLU gates lie within float32 rounding of 0 with
    a zero cotangent (counted: under 1% of the rows), and the same bits on
    two runs."""
    with torch.no_grad():
        if code_dim:
            ws, bs, g, sv, feat, code, co, cn = _radiance_case(dev, code_dim, n)
        else:
            _, ren = _nets(dev)
            ws, bs = effective_linear_weights(ren)
            g = _rand(dev, n, 3, seed=1)
            g[:5] = 0.0
            sv = torch.cat([_rand(dev, n, 3), positional_encoding(_rand(dev, n, 3, seed=2), 4)],
                           -1)
            feat, code = _rand(dev, n, 32, seed=3), None
            co, cn = _rand(dev, n, 3, seed=8), _rand(dev, n, 3, seed=9)
        if n > 700:
            from monosdf_torch.kernels.radiance_norm import normalize

            parts = [sv, normalize(g), feat] + ([code] if code is not None else [])
            cleared = _clear_gated_rows(co, torch.cat(parts, -1), ws, bs)
            assert int((cleared != co).any(-1).sum()) < n // 100
            co = cleared
        dws, dbs, dg, df, dc = radiance_norm_bwd(ws, bs, g, sv, feat, co, cn, dtype, code)
        p = radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, dtype, code)
        extra = [(dc, p[4])] if code is not None else []
        _check_grads([*dws, *dbs, dg, *(a for a, _ in extra)],
                     [*p[0], *p[1], p[2], *(b for _, b in extra)], dtype)
        _check([df], [p[3]], dtype)
        if n > 700:
            again = radiance_norm_bwd(ws, bs, g, sv, feat, co, cn, dtype, code)
            both = zip([*dws, *dbs, dg, df, dc], [*again[0], *again[1], *again[2:]])
            assert all(a is None or torch.equal(a, b) for a, b in both)


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
        **dict.fromkeys(before, 0), "sdf_grad": 1, "radiance_norm": 1, "sdf_grad_bwd": 1,
        "radiance_norm_bwd": 1}


def _k4_rays(dev, R, N, seed):
    """K4's inputs for R rays of N sorted samples, an SDF crossing zero once
    with noise: (sdf, dists_tail, d_star, beta_prev)."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 3.85, (R, N)), axis=-1)
    sdf = np.tanh(rng.uniform(0.8, 2.5, (R, 1)) - z) * 0.6 + 0.01 * rng.normal(size=(R, N))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    zt, st = t(z), t(sdf)
    dists = np.diff(z, axis=-1)
    dt = t(np.concatenate([dists, np.full((R, 1), 1e10)], -1))
    ds = torch.nn.functional.pad(_d_star(zt, st), (0, 1)).contiguous()
    bp = t(np.sqrt(np.sum(dists**2, -1) / (4 * np.log(1.1)))[:, None])
    return st, dt, ds, bp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [128, 640])
def test_k4_matches_plain(dev, dtype, N):
    st, dt, ds, bp = _k4_rays(dev, 96, N, N)
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


# K4's speculative kernel (4 warps a ray, the 3 midpoints of 2 bisection
# steps a round, the fast division where it keeps div.rn's bits) against its
# order reference, the same kernel at depth 1 (the sequential loop, div.rn
# throughout): bit for bit. 97 rays (a few blocks) and 4,096 (more blocks
# than the card holds at once); N = 352 is 11 samples a lane; beta0 1e-2
# and 1e-4 (the small one drives exp towards its subnormal range, where the
# kernel takes div.rn); the plain version within the smoke's bars
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [128, 352, 640])
@pytest.mark.parametrize("R", [97, 4096])
def test_k4_speculative_kernel_equals_its_sequential_reference(dev, R, N, dtype):
    st, dt, ds, bp = _k4_rays(dev, R, N, R + N)
    before, ref_before = build.launches["sampler_machinery"], build.reference_launches[
        "sampler_machinery_seq"]
    runs = 0
    for b0 in (1e-2, 1e-4):
        for last in (False, True):
            args = (st, dt, ds, bp, torch.tensor(b0, device=dev), 0.1, 1e-6, last, 10, dtype)
            bk, pk = sampler_iter_machinery(*args)
            bk2, pk2 = sampler_iter_machinery(*args)
            bs, ps = sampler_iter_machinery_seq(*args)
            bpl, ppl = sampler_iter_machinery_plain(*args)
            runs += 1
            torch.cuda.synchronize()
            for a, b in ((bk, bs), (pk, ps), (bk, bk2), (pk, pk2)):
                assert torch.equal(_bits(a), _bits(b))
            assert (bk - bpl).abs().max().item() <= bp.max().item() / 2**10
            assert torch.isfinite(pk).all()
            atol, rtol = K4_PDF_TOL[dtype]
            assert ((pk - ppl).abs() <= atol + rtol * ppl.abs()).all()
    assert build.launches["sampler_machinery"] - before == 2 * runs
    assert build.reference_launches["sampler_machinery_seq"] - ref_before == runs


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _sdf_trunk(dev, which):
    """(ws, bs, multires, skip_in, bounding sphere) of an SDF trunk: the
    small test trunk (48 wide, skip at 2, with a 1.1 clamp), or at full
    width the bench's MLP model's (8x256, skip at 4, PE(6), its 1.1 clamp)
    or the union model's (its own init, no clamp), each plus seeded noise."""
    from monosdf_torch.cli.eval import bench_mlp_config, union_codes_config

    cfg = {"small": IMP, "mlp": bench_mlp_config().implicit,
           "union": union_codes_config().implicit}[which]
    gen = torch.Generator().manual_seed(7)
    imp = init_implicit_net(cfg, gen)
    with torch.no_grad():
        for p in imp.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    ws, bs = (list(t.detach() for t in ts) for ts in effective_linear_weights(imp.to(dev)))
    sphere = 1.1 if which == "small" else cfg.sdf_bounding_sphere
    return ws, bs, cfg.multires, cfg.skip_in, sphere


# the render chunk's kernel (32-point tiles, one persistent CTA per SM)
# against its order reference: 700 points (22 tiles, the last ragged: 28
# points) and 8,461 (265 tiles, more than the card has SMs, so the tile
# loop wraps; the last 13 points)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [700, 8461])
@pytest.mark.parametrize("which", ["small", "mlp", "union"])
def test_k2f_render_chunk_kernel_equals_its_simt_reference(dev, which, n):
    """K2f's bf16 render chunk (no Z) gives the SIMT kernel's sdf, feat and
    grad bit for bit; one launch counted as sdf_grad, one as the order
    reference."""
    from monosdf_torch.kernels.sdf_grad import sdf_mlp_with_grad_simt

    ws, bs, multires, skip_in, sphere = _sdf_trunk(dev, which)
    x = _rand(dev, n, 3, lo=-1.3, hi=1.3, seed=4)
    before = dict(build.launches)
    ref_before = dict(build.reference_launches)
    with torch.no_grad():
        args = (ws, bs, x, multires, skip_in, torch.bfloat16, sphere, 1.0)
        out = sdf_mlp_with_grad(*args)
        ref = sdf_mlp_with_grad_simt(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a.float()).all()
        assert torch.equal(_bits(a), _bits(b)), (a.float() - b.float()).abs().max().item()
    if sphere > 0.0:  # the clamp fired on some points and not on others
        sq = sphere - x.norm(dim=-1, keepdim=True)
        assert 0 < int(((out[0] - sq).abs() < 1e-6).sum()) < n
    assert build.launches["sdf_grad"] - before["sdf_grad"] == 1
    assert build.reference_launches["sdf_grad_simt"] - ref_before["sdf_grad_simt"] == 1
    _check(out, sdf_mlp_with_grad_plain(*args), torch.bfloat16)


# K3f's bf16 kernel (the tensor cores, 64-row tiles on one persistent CTA
# per SM): 700 rows (11 tiles, the last ragged: 60 rows) and 16,901 (265
# tiles, more than the card has SMs; the last 5 rows), with and without the
# per-image code
@pytest.mark.cuda
@pytest.mark.parametrize("n", [700, 16901])
@pytest.mark.parametrize("code_dim", [0, 8])
def test_k3f_tensor_cores_match_plain(dev, code_dim, n):
    ws, bs, g, sv, feat, code, _, _ = _radiance_case(dev, code_dim=code_dim or 8, n=n)
    if code_dim == 0:  # the trunk without the code's W0 rows
        ws = [ws[0][:-8].contiguous(), *ws[1:]]
        code = None
    before = dict(build.launches)
    with torch.no_grad():
        out = radiance_norm(ws, bs, g, sv, feat, torch.bfloat16, code)
        ref = radiance_norm_plain(ws, bs, g, sv, feat, torch.bfloat16, code)
        again = radiance_norm(ws, bs, g, sv, feat, torch.bfloat16, code)
    torch.cuda.synchronize()
    _check(out, ref, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert build.launches["radiance_norm"] - before["radiance_norm"] == 2


# K8a's bf16 kernels on the tensor cores (the forward K3f's body, the
# backward K3b's two passes, with K8a's segments: float32 sv, raw gradient
# and code, a float32 co, no normalise step): 700 rows (11 tiles, the last
# ragged: 60 rows) and 16,901 (265 tiles, more than the card has SMs; the
# last 5 rows), with and without the per-image code
@pytest.mark.cuda
@pytest.mark.parametrize("n", [700, 16901])
@pytest.mark.parametrize("code_dim", [0, 8])
def test_k8a_tensor_cores_match_plain(dev, code_dim, n):
    """K8a forward and backward against their plain versions at the bf16
    bars (the output and df at TOL; dW, db, dn and dc at GRAD_TOL), the
    rows whose ReLU gates lie within float32 rounding of 0 with a zero
    cotangent; two runs give the same bits; one launch of each kernel a
    call."""
    from monosdf_torch.kernels import radiance_split as k8a

    ws, bs, g, sv, feat, code, co, _ = _radiance_case(dev, code_dim=code_dim or 8, n=n)
    if code_dim == 0:  # the trunk without the code's W0 rows
        ws = [ws[0][:-8].contiguous(), *ws[1:]]
        code = None
    bf = torch.bfloat16
    before = dict(build.launches)
    with torch.no_grad():
        co = _clear_gated_rows(co, torch.cat([sv, g, feat, *([code] if code_dim else [])], -1),
                               ws, bs)
        out = [k8a.radiance_split(ws, bs, g, sv, feat, code, bf) for _ in range(2)]
        bwd = [k8a.radiance_split_bwd(ws, bs, g, sv, feat, code, co, bf) for _ in range(2)]
        ref = k8a.radiance_split_plain(ws, bs, g, sv, feat, code, bf)
        p = k8a.radiance_split_bwd_plain(ws, bs, g, sv, feat, code, co, bf)
    torch.cuda.synchronize()
    _check([out[0]], [ref], bf)
    dws, dbs, dn, df, dc = bwd[0]
    assert dn.dtype == torch.float32 and df.dtype == bf and (dc is None) == (code is None)
    _check_grads([*dws, *dbs, dn, *([dc] if code_dim else [])],
                 [*p[0], *p[1], p[2], *([p[4]] if code_dim else [])], bf)
    _check([df], [p[3]], bf)
    assert torch.equal(out[0], out[1])
    flat = [[*b[0], *b[1], *b[2:]] for b in bwd]
    assert all(a is None or torch.equal(a, b) for a, b in zip(*flat))
    assert {k: build.launches[k] - before[k] for k in ("radiance_split", "radiance_split_bwd")} == {
        "radiance_split": 2, "radiance_split_bwd": 2}


# K8b's bf16 kernels on the tensor cores (the forward K3f's body, the
# backward K3b's two passes, on one float32 segment, h0, every column with
# a cotangent output): nerf mode's input row without and with a code (283,
# 315), the widest the kernels take (336), and a narrow one (27: the view
# PE alone); one and two hidden layers of 256, nout 3 and 4; 97 rows (two
# tiles, the last ragged: 33 rows) and 16,901 (265 tiles, more than 2 per
# SM, the last 5 rows)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [97, 16901])
@pytest.mark.parametrize("nout", [3, 4])
@pytest.mark.parametrize("hidden", [1, 2])
@pytest.mark.parametrize("d0", [27, 283, 315, 336])
def test_k8b_tensor_cores_match_plain(dev, d0, hidden, nout, n):
    """K8b forward and backward against their plain versions at the bf16
    bars (the output at TOL; dW, db and dh0 at GRAD_TOL), the rows whose
    ReLU gates lie within float32 rounding of 0 with a zero cotangent; two
    runs give the same bits; one launch of each kernel a call."""
    from monosdf_torch.kernels import radiance_mlp as k8b

    rng = np.random.default_rng(d0 + 10 * hidden + nout)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    sizes = (d0, *[256] * hidden, nout)
    ws = [t(rng.normal(size=(a, b)) / np.sqrt(a)) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [t(0.1 * rng.normal(size=b)) for b in sizes[1:]]
    h0 = t(rng.normal(size=(n, d0)))
    bf = torch.bfloat16
    before = dict(build.launches)
    with torch.no_grad():
        co = _clear_gated_rows(t(rng.normal(size=(n, nout))), h0, ws, bs)
        out = [k8b.mlp_with_input_grad(ws, bs, h0, bf) for _ in range(2)]
        bwd = [k8b.mlp_with_input_grad_bwd(ws, bs, h0, co, bf) for _ in range(2)]
        ref = k8b.mlp_plain(ws, bs, h0, bf)
        p = k8b.mlp_bwd_plain(ws, bs, h0, co, bf)
    torch.cuda.synchronize()
    _check([out[0]], [ref], bf)
    dws, dbs, dh0 = bwd[0]
    assert dh0.dtype == torch.float32 and dh0.shape == (n, d0)
    _check_grads([*dws, *dbs, dh0], [*p[0], *p[1], p[2]], bf)
    assert torch.equal(_bits(out[0]), _bits(out[1]))
    flat = [[*b[0], *b[1], b[2]] for b in bwd]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(*flat))
    assert {k: build.launches[k] - before[k] for k in ("radiance_mlp", "radiance_mlp_bwd")} == {
        "radiance_mlp": 2, "radiance_mlp_bwd": 2}


def _ordered_column_sums(co, ctas):
    """co's column sums (float32) in the tensor-core backward's order: each
    64-row tile's rows in order (zeros past N), a persistent CTA's tiles
    (ctas apart) in order, then the CTAs in order."""
    n, k = co.shape
    tiles = -(-n // 64)
    rows = np.zeros((tiles * 64, k), np.float32)
    rows[:n] = co.float().cpu().numpy()
    rows = rows.reshape(tiles, 64, k)
    per_tile = np.zeros((tiles, k), np.float32)
    for r in range(64):
        per_tile += rows[:, r]
    part = np.zeros((ctas, k), np.float32)
    for t0 in range(0, tiles, ctas):
        chunk = per_tile[t0:t0 + ctas]
        part[:len(chunk)] += chunk
    total = np.zeros(k, np.float32)
    for b in range(ctas):
        total += part[b]
    return torch.from_numpy(total)


# the output layer's db of the tensor-core backward, whose top cotangent
# may be float32 (K8a) or bf16 (K3b), at 16,901 rows (265 tiles over the
# persistent CTAs)
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k3b", "k8a"])
def test_tensor_core_backward_output_bias_gradient_is_the_ordered_sum_of_co(dev, which):
    """db of the output layer, bit for bit, is the top cotangent summed in
    the kernels' fixed order: K3b's co rounded to bf16 (its rounded and
    unrounded copies coincide), K8a's float32 co unrounded (the TPU kernel
    sums it before its cast); every output within its bar (the rows with
    an ambiguous ReLU gate cleared) and the same bits on two runs."""
    from monosdf_torch.kernels import radiance_split as k8a

    from monosdf_torch.kernels.radiance_norm import normalize

    n, bf = 16901, torch.bfloat16
    ws, bs, g, sv, feat, code, co, cn = _radiance_case(dev, n=n)
    with torch.no_grad():
        h0 = torch.cat([sv, normalize(g) if which == "k3b" else g, feat, code], -1)
        co = _clear_gated_rows(co * 3.0 + 0.01, h0, ws, bs)  # most values off the bf16 grid
        if which == "k3b":
            runs = [radiance_norm_bwd(ws, bs, g, sv, feat, co, cn, bf, code) for _ in range(2)]
            p = radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, bf, code)
            summed = co.to(bf)
        else:
            runs = [k8a.radiance_split_bwd(ws, bs, g, sv, feat, code, co, bf) for _ in range(2)]
            p = k8a.radiance_split_bwd_plain(ws, bs, g, sv, feat, code, co, bf)
            summed = co
    torch.cuda.synchronize()
    ctas = min(torch.cuda.get_device_properties(dev).multi_processor_count, -(-n // 64))
    db_top = runs[0][1][-1]
    assert torch.equal(db_top.cpu(), _ordered_column_sums(summed, ctas))
    assert not torch.equal(_ordered_column_sums(co.to(bf), ctas), _ordered_column_sums(co, ctas))
    flat = [[*r[0], *r[1], *r[2:]] for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))
    dws, dbs, d_in, df, dc = runs[0]
    _check_grads([*dws, *dbs, d_in, dc], [*p[0], *p[1], p[2], p[4]], bf)
    _check([df], [p[3]], bf)


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
    # K6 counts (point, level) pairs and zero columns in 32-bit ints: its
    # launch refuses a count past that before it reads a buffer
    from monosdf_torch.kernels import hash_encode as k6

    desc, fdesc, _ = k6._levels(_grid_cfg("float32"), 1.0, 1.0)
    launch = k6._lib(k6.NAME).hash_encode_launch
    for n, k in ((2**29, 6), (2**29, 0)):  # 3.2e9 pairs; 3.2e9 zero columns
        assert launch(None, None, n, k, desc, fdesc, 1.0, None, None, 0, None) != 0


# -- the grid model's kernels: K6, K5, K7 ------------------------------------

def _grid_cfg(table_dtype):
    from monosdf_torch.ops.hashgrid import HashGridConfig

    return HashGridConfig(num_levels=6, level_dim=2, base_resolution=16, log2_hashmap_size=12,
                          desired_resolution=128, hash_scheme="add", table_dtype=table_dtype,
                          param_flat=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k6_k5_match_plain(dev, dtype):
    """K6 (features and tangents, all and the first 3 levels) and K5 against
    their plain versions on 700 points, some outside the box. K6 reads the
    same corner values as its plain version and sums in float32, so a bf16
    table holds at the float32 TOL. K5 row by row, |a - b| <= atol + rtol *
    S with S the row's sum, over its corner terms, of the magnitudes each is
    made from (|c_feat| W + sum_k |c_tg_k| |dW_k|): a term's float32
    rounding where its parts cancel, the atomics' order, and at bf16 a
    term's rounding landing on the neighbouring value (2^-7 of the term)."""
    from monosdf_torch.kernels.hash_encode import (
        hash_encode_bwd,
        hash_encode_bwd_plain,
        hash_encode_fwd,
        hash_encode_fwd_plain,
    )
    from monosdf_torch.ops.hashgrid import corner_geometry, corner_weights

    cfg = _grid_cfg("bfloat16" if dtype is not None else "float32")
    gen = torch.Generator().manual_seed(0)
    table = (torch.rand(cfg.table_size * 2, generator=gen) * 2 - 1).to(dev)
    table = table.to(dtype) if dtype is not None else table
    x = _rand(dev, 700, 3, lo=-1.1, hi=1.1, seed=3)
    before = dict(build.launches)
    for n_levels in (None, 3):
        _check([hash_encode_fwd(table, cfg, x, 1.0, n_levels)],
               [hash_encode_fwd_plain(table, cfg, x, 1.0, n_levels)], None)
    _check(hash_encode_fwd(table, cfg, x, 1.0, None, True, 0.5),
           hash_encode_fwd_plain(table, cfg, x, 1.0, None, True, 0.5), None)
    cf, ct = _rand(dev, 700, 12, seed=4), _rand(dev, 3, 700, 12, seed=5)
    d = hash_encode_bwd(cfg, x, cf, ct, 1.0, 0.5)
    dp = hash_encode_bwd_plain(cfg, x, cf, ct, 1.0, 0.5)
    idx, w, dw, inb = corner_geometry(cfg, x, 1.0, 6, 0.5)
    W, dW = corner_weights(w, dw)
    mag = (W[..., None] * (cf.abs() * inb[:, None]).reshape(700, 6, 2).permute(1, 0, 2)[None]
           + torch.einsum("jcln,jlnd->clnd", dW.abs(),
                          (ct.abs() * inb[:, None]).reshape(3, 700, 6, 2).permute(0, 2, 1, 3)))
    s = torch.zeros(cfg.table_size, 2, device=dev).index_add_(
        0, idx.reshape(-1), mag.reshape(-1, 2)).reshape(-1)
    rtol = 1e-4 if dtype is None else 2**-7 + 1e-4
    assert torch.isfinite(d).all()
    assert ((d - dp).abs() <= 1e-6 + rtol * s).all(), float((d - dp).abs().max())
    torch.cuda.synchronize()
    assert build.launches["hash_encode"] - before["hash_encode"] == 3
    assert build.launches["hash_encode_bwd"] - before["hash_encode_bwd"] == 1


# K6 against its plain version over the level schedules it meets: one
# level, 6, and 16 mixing dense levels of non-power-of-two sizes with hashed
# ones; both hash schemes, both table types; 1,001 points (a ragged last
# block), a fifth of them outside the box, and ray-ordered points (1,001 =
# 7 rays x 143 samples through the box); the sweep's truncation (the first
# levels only, zeros after) with and without tangents; two runs give the
# same bits. Features and tangents at ENCODE_TOL (per tensor).
ENCODE_TOL = (1e-4, 1e-4)
K6_CASES = {
    "1": dict(num_levels=1, base_resolution=17, desired_resolution=None),
    "6": dict(num_levels=6, base_resolution=16, log2_hashmap_size=12, desired_resolution=128),
    "16": dict(num_levels=16, base_resolution=3, log2_hashmap_size=15, desired_resolution=512),
}


def _ray_points(rng, n_rays, n_per_ray):
    """(n_rays * n_per_ray, 3) points in ray order: rays from 1.5 off the
    centre towards the middle of the box [-1, 1]^3, each at uniform spacing
    from where it enters the box to where it leaves."""
    o = rng.normal(size=(n_rays, 3))
    o = 1.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        t1, t2 = (-1.0 - o) / d, (1.0 - o) / d
    near = np.maximum(np.max(np.minimum(t1, t2), axis=1), 0.0)
    far = np.min(np.maximum(t1, t2), axis=1)
    z = near[:, None] + (far - near)[:, None] * np.linspace(0.0, 1.0, n_per_ray)[None]
    return (o[:, None] + z[..., None] * d[:, None]).reshape(-1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["add", "xor"])
@pytest.mark.parametrize("levels", list(K6_CASES))
def test_k6_matches_plain_over_levels_schemes_and_points(dev, levels, scheme, table_dtype):
    from monosdf_torch.kernels.hash_encode import hash_encode_fwd, hash_encode_fwd_plain
    from monosdf_torch.ops.hashgrid import HashGridConfig

    cfg = HashGridConfig(level_dim=2, hash_scheme=scheme, table_dtype=table_dtype,
                         param_flat=True, **K6_CASES[levels])
    gen = torch.Generator().manual_seed(1)
    table = (torch.rand(cfg.table_size * 2, generator=gen) * 2 - 1).to(dev)
    table = table.to(torch.bfloat16) if table_dtype == "bfloat16" else table
    rng = np.random.default_rng(2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    points = {"box": t(rng.uniform(-1.25, 1.25, (1001, 3))),
              "rays": t(_ray_points(rng, 7, 143))}
    L = cfg.num_levels
    atol, rtol = ENCODE_TOL
    before = build.launches["hash_encode"]
    for x in points.values():
        for n_levels in sorted({None, 1, min(3, L), L}, key=lambda v: -1 if v is None else v):
            for tangents in (False, True):
                out = hash_encode_fwd(table, cfg, x, 1.0, n_levels, tangents, 0.7)
                again = hash_encode_fwd(table, cfg, x, 1.0, n_levels, tangents, 0.7)
                ref = hash_encode_fwd_plain(table, cfg, x, 1.0, n_levels, tangents, 0.7)
                out, again, ref = ((v,) if not tangents else v for v in (out, again, ref))
                for a, b, c in zip(out, ref, again):
                    assert a.shape == b.shape and torch.isfinite(a).all()
                    err = (a - b).abs().max().item()
                    assert err <= atol + rtol * b.abs().max().item(), (n_levels, tangents, err)
                    assert torch.equal(_bits(a), _bits(c))
                    if n_levels is not None and n_levels < L:
                        assert not a.reshape(*a.shape[:-1], L, 2)[..., n_levels:, :].any()
    torch.cuda.synchronize()
    assert build.launches["hash_encode"] - before == 2 * 2 * 2 * len(
        {None, 1, min(3, L), L})


def _k5_row_bar(cfg, x, cf, ct, tangent_scale, dtype_name):
    """K5's row-by-row bar, 1e-6 + rtol * S, S each row's sum over its
    corner terms of |c_feat| W + sum_k |c_tg_k| |dW/dx_k| (as
    test_k6_k5_match_plain)."""
    from monosdf_torch.ops.hashgrid import corner_geometry, corner_weights

    N, L = x.shape[0], cfg.num_levels
    idx, w, dw, inb = corner_geometry(cfg, x, 1.0, L, tangent_scale)
    W, dW = corner_weights(w, dw)
    mag = W[..., None] * (cf.abs() * inb[:, None]).reshape(N, L, 2).permute(1, 0, 2)[None]
    if ct is not None:
        mag = mag + torch.einsum("jcln,jlnd->clnd", dW.abs(),
                                 (ct.abs() * inb[:, None]).reshape(3, N, L, 2).permute(0, 2, 1, 3))
    s = torch.zeros(cfg.table_size, 2, device=x.device).index_add_(
        0, idx.reshape(-1), mag.reshape(-1, 2)).reshape(-1)
    return 1e-6 + (1e-4 if dtype_name == "float32" else 2**-7 + 1e-4) * s


# K5 against its plain version over the level schedules of K6's test (1, 6
# and 16 levels), both hash schemes and both table types, with and without
# tangents: 40,007 points in and around the box (1,251 CTAs of 32 points,
# more than the card has SMs; the last ragged, 7 points; a fifth outside,
# which add nothing), ray-ordered points (7 rays x 143 samples) and 2,048
# points in one cell of every level (every lane of every warp in one run,
# the most contention). Row by row at the bar of chip_smoke.py
# ENCODE_BWD_TOL.
@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["add", "xor"])
@pytest.mark.parametrize("levels", ["1", "6", "16"])
def test_k5_matches_plain_over_levels_schemes_and_points(dev, levels, scheme, table_dtype):
    from monosdf_torch.kernels.hash_encode import hash_encode_bwd, hash_encode_bwd_plain
    from monosdf_torch.ops.hashgrid import HashGridConfig

    cfg = HashGridConfig(level_dim=2, hash_scheme=scheme, table_dtype=table_dtype,
                         param_flat=True, **K6_CASES[levels])
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    corner = rng.uniform(-0.5, 0.5, 3)
    points = {"box": t(rng.uniform(-1.25, 1.25, (40007, 3))),
              "rays": t(_ray_points(rng, 7, 143)),
              "one-cell": t(corner + rng.uniform(0.0, 1e-5, (2048, 3)))}
    L = cfg.num_levels
    before = build.launches["hash_encode_bwd"]
    for name, x in points.items():
        n = x.shape[0]
        cf, ct = t(rng.normal(size=(n, 2 * L))), t(rng.normal(size=(3, n, 2 * L)))
        for c_tg in (ct, None):
            d = hash_encode_bwd(cfg, x, cf, c_tg, 1.0, 0.7)
            dp = hash_encode_bwd_plain(cfg, x, cf, c_tg, 1.0, 0.7)
            assert d.shape == dp.shape and torch.isfinite(d).all()
            bar = _k5_row_bar(cfg, x, cf, c_tg, 0.7, table_dtype)
            err = (d - dp).abs()
            assert (err <= bar).all(), (name, c_tg is None, float((err / bar).max()))
    torch.cuda.synchronize()
    assert build.launches["hash_encode_bwd"] - before == 2 * len(points)


@pytest.mark.cuda
def test_k5_rounds_each_term_to_bf16_before_summing(dev):
    """Three identical points on a bf16 table of one dense level: each of
    their 8 corner rows gets exactly 3 bf16(t), t the corner's term, as
    index_add_ of the rounded terms (the plain version) gives; the
    cotangent is chosen so that bf16(3 t) differs from 3 bf16(t) on some
    row, so a sum taken before the rounding would show."""
    import dataclasses

    from monosdf_torch.kernels.hash_encode import corner_terms, hash_encode_bwd, hash_encode_bwd_plain
    from monosdf_torch.ops.hashgrid import HashGridConfig

    cfg = HashGridConfig(level_dim=2, table_dtype="bfloat16", param_flat=True, **K6_CASES["1"])
    x = torch.tensor([[0.123, -0.456, 0.789]] * 3, device=dev)
    cf = torch.tensor([[1.0 + 2**-7 + 2**-9, -(1.0 + 2**-8 + 2**-10)]] * 3, device=dev)
    d = hash_encode_bwd(cfg, x, cf, None, 1.0, 1.0)
    dp = hash_encode_bwd_plain(cfg, x, cf, None, 1.0, 1.0)
    rows, u = corner_terms(cfg, x[:1], cf[:1], None, 1.0, 1.0)  # one point's rounded terms
    _, t = corner_terms(dataclasses.replace(cfg, table_dtype="float32"), x[:1], cf[:1], None)
    assert len(set(rows.tolist())) == 8  # a dense level: 8 distinct rows
    assert torch.equal(t.bfloat16().float(), u)
    assert not torch.equal((3 * t).bfloat16().float(), 3 * u)
    want = torch.zeros(cfg.table_size, 2, device=dev).index_put_((rows,), 3 * u).reshape(-1)
    assert torch.equal(d, want) and torch.equal(dp, want)


# 40,007 points: 1,251 32-point tiles of the bf16 K7f (with Z: the tensor
# cores) and 2,501 16-point tiles of K7b's pass 1, more than the card has
# SMs, the last ones ragged (7 points); pass 2 splits its tiles
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(None, 700), (torch.bfloat16, 700), (torch.bfloat16, 40007)],
                         ids=["f32", "bf16", "bf16-40007"])
def test_k7_forward_and_backward_match_plain(dev, dtype, n):
    from monosdf_torch.kernels.sdf_grad_grid import (
        _forward,
        sdf_mlp_with_grad_in_bwd,
        sdf_mlp_with_grad_in_bwd_plain,
        sdf_mlp_with_grad_in_plain,
    )

    rng = np.random.default_rng(6)
    sizes = (71, 48, 48, 33)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    ws = [t(rng.normal(size=(a, b)) / np.sqrt(a)) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [t(0.1 * rng.normal(size=b)) for b in sizes[1:]]
    a0 = t(rng.normal(size=(4, n, 71)))
    sdf, feat, grad, zs = _forward(ws, bs, a0, dtype, True)
    ref = sdf_mlp_with_grad_in_plain(ws, bs, a0, dtype, True)
    _check([sdf, feat, grad, *zs], [*ref[:3], *ref[3]], dtype)
    _check(_forward(ws, bs, a0, dtype, False), ref[:3], dtype)  # the render chunk's variant
    cots = [t(rng.normal(size=(n, k))) for k in (1, 32, 3)]
    dws, dbs, da0 = sdf_mlp_with_grad_in_bwd(ws, bs, a0, zs, *cots, dtype)
    pws, pbs, pda0 = sdf_mlp_with_grad_in_bwd_plain(ws, bs, a0, zs, *cots, dtype)
    _check_grads([*dws, *dbs, da0], [*pws, *pbs, pda0], dtype)
    again = sdf_mlp_with_grad_in_bwd(ws, bs, a0, zs, *cots, dtype)
    assert all(torch.equal(a, b) for a, b in zip([*dws, *dbs, da0], [*again[0], *again[1],
                                                                     again[2]]))


@pytest.mark.cuda
def test_grid_autograd_functions_launch_their_kernels(dev):
    """The grid diff path under grad: K6 and K7f forward, K7b and K5 backward."""
    from monosdf_torch.models.fields import (
        ImplicitNetConfig as Imp,
        grid_table,
        init_implicit_net as init_imp,
        sdf_feat_grad_pallas_grid,
    )

    cfg = Imp(feature_vector_size=32, dims=(48, 48), multires=6, use_grid=True,
              divide_factor=1.1, sdf_bounding_sphere=0.0, grid=_grid_cfg("bfloat16"))
    net = init_imp(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, device=dev))
    before = dict(build.launches)
    x = _rand(dev, 300, 3)
    sdf, feat, grad = sdf_feat_grad_pallas_grid(net, cfg, x, torch.bfloat16,
                                                table=grid_table(net, cfg))
    (sdf.sum() + feat.float().sum() + (grad**2).sum()).backward()
    torch.cuda.synchronize()
    for p in net.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    assert net.encoding.embeddings.grad.abs().max() > 0
    assert {k: build.launches[k] - before[k] for k in
            ("hash_encode", "hash_encode_bwd", "sdf_grad_grid", "sdf_grad_grid_bwd")} == {
        "hash_encode": 1, "hash_encode_bwd": 1, "sdf_grad_grid": 1, "sdf_grad_grid_bwd": 1}


# -- the radiance kernels with codes: K3, K8a, K8b ------------------------------

def _radiance_case(dev, code_dim=8, n=700):
    """The rendering net with codes and its inputs: (ws, bs, normals or g,
    sv, feat, code, co, cn)."""
    cfg = RenderingNetConfig(feature_vector_size=32, dims=(48, 48), multires_view=4,
                             per_image_code=True, code_dim=code_dim, max_images=4)
    gen = torch.Generator().manual_seed(3)
    ren = init_rendering_net(cfg, gen)
    with torch.no_grad():
        for p in ren.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    ws, bs = (list(t.detach() for t in ts) for ts in effective_linear_weights(ren.to(dev)))
    g = _rand(dev, n, 3, seed=1)
    g[:5] = 0.0
    sv = torch.cat([_rand(dev, n, 3), positional_encoding(_rand(dev, n, 3, seed=2), 4)], -1)
    return (ws, bs, g, sv, _rand(dev, n, 32, seed=3), _rand(dev, n, code_dim, seed=4),
            _rand(dev, n, 3, seed=8), _rand(dev, n, 3, seed=9))


def _clear_gated_rows(co, h0, ws, bs):
    """co with the rows zeroed whose hidden pre-activations (float64) lie
    within float32 rounding of 0 (|y| < 1e-5): there the ReLU gate of two
    float32 implementations may differ, which changes that row's whole
    backward. With a zero cotangent such a row adds nothing to any output,
    whatever its gates."""
    h = h0.double()
    ambiguous = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    for w, b in zip(ws[:-1], bs[:-1]):
        y = h @ w.double() + b.double()
        ambiguous |= (y.abs() < 1e-5).any(-1)
        h = torch.relu(y)
    return torch.where(ambiguous[:, None], torch.zeros_like(co), co)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_radiance_kernels_with_codes_match_plain(dev, dtype):
    """K3 with the code operand, K8a and K8b (nerf's [view PE | features |
    code]), forward and backward, against their plain versions; one launch
    of each."""
    from monosdf_torch.kernels import radiance_mlp as k8b
    from monosdf_torch.kernels import radiance_split as k8a

    from monosdf_torch.kernels.radiance_norm import normalize

    ws, bs, g, sv, feat, code, co, cn = _radiance_case(dev)
    before = dict(build.launches)
    with torch.no_grad():
        h0 = torch.cat([sv, normalize(g), feat, code], -1)
        co = _clear_gated_rows(co, h0, ws, bs)
        _check(radiance_norm(ws, bs, g, sv, feat, dtype, code),
               radiance_norm_plain(ws, bs, g, sv, feat, dtype, code), dtype)
        dws, dbs, dg, df, dc = radiance_norm_bwd(ws, bs, g, sv, feat, co, cn, dtype, code)
        p = radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, dtype, code)
        _check_grads([*dws, *dbs, dg, dc], [*p[0], *p[1], p[2], p[4]], dtype)
        _check([df], [p[3]], dtype)
        _check([k8a.radiance_split(ws, bs, g, sv, feat, code, dtype)],
               [k8a.radiance_split_plain(ws, bs, g, sv, feat, code, dtype)], dtype)
        co = _clear_gated_rows(co, torch.cat([sv, g, feat, code], -1), ws, bs)
        dws, dbs, dn, df, dc = k8a.radiance_split_bwd(ws, bs, g, sv, feat, code, co, dtype)
        p = k8a.radiance_split_bwd_plain(ws, bs, g, sv, feat, code, co, dtype)
        _check_grads([*dws, *dbs, dn, dc], [*p[0], *p[1], p[2], p[4]], dtype)
        _check([df], [p[3]], dtype)
        # nerf mode's trunk: W0 rows [view PE | features | code]
        h0 = torch.cat([sv[:, 3:], feat, code], -1)
        nws = [_rand(dev, h0.shape[1], 48, seed=11) / 8.0, ws[1], ws[2]]
        _check([k8b.mlp_with_input_grad(nws, bs, h0, dtype)],
               [k8b.mlp_plain(nws, bs, h0, dtype)], dtype)
        co = _clear_gated_rows(co, h0, nws, bs)
        dws, dbs, dh0 = k8b.mlp_with_input_grad_bwd(nws, bs, h0, co, dtype)
        p = k8b.mlp_bwd_plain(nws, bs, h0, co, dtype)
        _check_grads([*dws, *dbs, dh0], [*p[0], *p[1], p[2]], dtype)
        again = k8b.mlp_with_input_grad_bwd(nws, bs, h0, co, dtype)
        assert all(torch.equal(a, b) for a, b in zip([*dws, *dbs, dh0],
                                                     [*again[0], *again[1], again[2]]))
    torch.cuda.synchronize()
    assert {k: build.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "radiance_norm": 1, "radiance_norm_bwd": 1,
        "radiance_split": 1, "radiance_split_bwd": 1, "radiance_mlp": 1, "radiance_mlp_bwd": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "idr", "nerf"])
def test_radiance_fields_with_codes_launch_their_kernels(dev, mode):
    """Under grad, the radiance field functions with codes launch one
    forward and one backward kernel each: rendering_apply_pallas_wide K3,
    rendering_apply_pallas K8a (idr) or K8b (nerf); finite gradients for
    the parameters, the features and the codes."""
    from monosdf_torch.models.fields import rendering_apply_pallas, rendering_apply_pallas_wide

    cfg = RenderingNetConfig(feature_vector_size=32, dims=(48, 48), multires_view=4,
                             mode="nerf" if mode == "nerf" else "idr",
                             d_in=3 if mode == "nerf" else 9, per_image_code=True, code_dim=8,
                             max_images=4)
    ren = init_rendering_net(cfg, torch.Generator().manual_seed(0), dev)
    x, g, d = _rand(dev, 300, 3), _rand(dev, 300, 3, seed=1), _rand(dev, 300, 3, seed=2)
    feat = _rand(dev, 300, 32, seed=3).to(torch.bfloat16).requires_grad_()
    code = ren.embeddings[torch.arange(300, device=dev) % 4]
    before = dict(build.launches)
    fn = rendering_apply_pallas_wide if mode == "fused" else rendering_apply_pallas
    out = fn(ren, cfg, x, g, d, feat, code, dtype=torch.bfloat16)
    out["rgb"].sum().backward()
    torch.cuda.synchronize()
    for t in [*ren.parameters(), feat]:
        assert t.grad is not None and torch.isfinite(t.grad.float()).all()
    assert ren.embeddings.grad.abs().max() > 0
    name = {"fused": "radiance_norm", "idr": "radiance_split", "nerf": "radiance_mlp"}[mode]
    assert {k: build.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), name: 1, f"{name}_bwd": 1}



# -- the probe kernels (kernels/probes.py) at the probe's site shapes --------

def _launched(before):
    return {k: v - before[k] for k, v in build.launches.items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,axis,dtype,reps,where", [
    (8, 8, 0, torch.float32, 32, "shared"), (8192, 8192, 0, torch.float32, 32, "shared"),
    (512, 512, 1, torch.float32, 32, "shared"), (32768, 2048, 0, torch.bfloat16, 8, "l2")])
def test_probe_gather_matches_plain(dev, rows, n, axis, dtype, reps, where):
    """G at P1's and P8's shapes and reps, exactly: the same float32 adds in
    order."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(rows + axis)
    tbl = torch.randn(rows, 128, generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, rows if axis == 0 else 128, (n, 128), generator=gen, device=dev,
                        dtype=torch.int32)
    before, seen = dict(build.launches), []
    out = probes.gather(tbl, idx, axis, reps, seen)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_gather": 1} and seen == [where]
    assert torch.equal(out, probes.gather_plain(tbl, idx, axis, reps))


def _gather_case(dev, rows, n, axis, dtype, seed):
    """A table of seeded normal values and indices that reach 50 past
    either end of the gathered axis (clamped by the kernel)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbl = torch.randn(rows, 128, generator=gen, device=dev).to(dtype)
    hi = rows if axis == 0 else 128
    idx = torch.randint(-50, hi + 50, (n, 128), generator=gen, device=dev, dtype=torch.int32)
    return tbl, idx


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,reps,dtype,width,where", [
    (512, 1000, 4, torch.float32, 3, "shared"),        # ragged last column slice and row block
    (512, 4096, 4, torch.float32, None, "shared"),     # 16 slices x 33 blocks: more CTAs than SMs
    (8192, 8192, 32, torch.float32, None, "shared"),   # P1: 32 slices x 4 blocks
    (4096, 1001, 8, torch.bfloat16, None, "shared"),   # 8 slices x 16 blocks, the last ragged
    (4099, 1001, 8, torch.bfloat16, 5, "shared"),      # 10-byte rows of a slice, staged 2 bytes a load
    ("limit", 2048, 32, torch.float32, None, "shared"),  # one column just fits
    ("limit+1", 2048, 32, torch.float32, None, "l2"),    # one column does not
    ("limit", 2048, 64, torch.bfloat16, None, "shared"),
    ("limit+1", 2048, 64, torch.bfloat16, None, "l2"),
    (4096, 256, 16, torch.float32, None, "shared"),    # reps n == rows: staged
    (4096, 256, 15, torch.float32, None, "l2"),        # reps n < rows: through L2
    (4096, 256, 16, torch.bfloat16, None, "shared"),
    (4096, 256, 15, torch.bfloat16, None, "l2"),
    (7, 3, 32, torch.float32, None, "shared")])         # a 7-row table, 3 output rows, one block
def test_probe_gather_staging_over_slices_blocks_and_rules(dev, rows, n, reps, dtype, width, where):
    """G along axis 0 over column-slice widths, row blocks and both sides of
    its staging rules (reps n >= rows; a one-column slice within the card's
    per-block shared memory, at the limit and one row past it): the plain
    version's bits with indices clamped into the table, the reported
    ``where``, one launch a call and a second call bit-equal."""
    from monosdf_torch.kernels import probes

    limits = probes.gather_limits(torch.cuda.current_device())
    if isinstance(rows, str):
        rows = limits[0] // (2 if dtype == torch.bfloat16 else 4) + rows.endswith("+1")
    tbl, idx = _gather_case(dev, rows, n, 0, dtype, rows + n + reps)
    plan = probes.gather_plan(rows, n, 0, reps, tbl.element_size(), limits, width)
    if n == 4096:
        assert plan[3] > limits[1]  # more CTAs than SMs
    before, seen = dict(build.launches), []
    out = probes.gather(tbl, idx, 0, reps, seen, width=width)
    again = probes.gather(tbl, idx, 0, reps, width=width)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_gather": 2} and seen == [where] == [plan[0]]
    assert torch.equal(out, again)
    assert torch.equal(out, probes.gather_plain(tbl, idx, 0, reps))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dtype", [(512, torch.float32), (1001, torch.bfloat16)])
def test_probe_gather_axis1_clamps_and_takes_a_ragged_last_cta(dev, rows, dtype):
    """G along axis 1 (AX1_ROWS rows a CTA, the last ragged at 1001 rows):
    indices outside the row clamped, the plain version's bits, "shared"."""
    from monosdf_torch.kernels import probes

    tbl, idx = _gather_case(dev, rows, rows, 1, dtype, rows)
    before, seen = dict(build.launches), []
    out = probes.gather(tbl, idx, 1, 32, seen)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_gather": 1} and seen == ["shared"]
    assert torch.equal(out, probes.gather_plain(tbl, idx, 1, 32))


@pytest.mark.cuda
def test_probe_capacity_grants_above_its_high_water_mark_and_refuses_past_the_card(dev):
    """C over sizes that are no multiple of its 4 KB bulk-store piece (512 B,
    4.5 KB, 227 KB) and in an order that crosses its high-water mark: a
    granted size after a refused one, a refused size (one row past the
    card's per-block maximum, then 32 MB) after a granted one, each refusal
    at cudaFuncSetAttribute with no launch counted."""
    from monosdf_torch.kernels import probes

    optin_rows = probes.device_limits(dev)["sharedMemPerBlockOptin"] // 512
    for rows, granted in ((1, True), (9, True), (optin_rows, True), (optin_rows + 1, False),
                          (64, True), (optin_rows, True), (32 * 1024 * 1024 // 512, False),
                          (optin_rows - 1, True)):
        before = dict(build.launches)
        if granted:
            out = probes.capacity(rows, dev)
            torch.cuda.synchronize()
            assert _launched(before) == {"probe_capacity": 1}
            assert torch.equal(out, probes.capacity_plain(rows, dev))
        else:
            with pytest.raises(probes.Refused, match="cudaFuncSetAttribute") as e:
                probes.capacity(rows, dev)
            assert e.value.where == "cudaFuncSetAttribute" and _launched(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,run,dtype,conflict", [
    (512, 4096, 8, torch.float32, False), (100_352, 65_536, 1, torch.float32, False),
    (100_352, 65_536, 1, torch.bfloat16, True)])
def test_probe_scatter_rows_matches_plain(dev, n, rows, run, dtype, conflict):
    """S at P2's and P4's shapes: per entry within 1e-5 of the sum of the
    magnitudes of its terms (the atomics add in another order)."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(n)
    offs = torch.randint(0, rows - run + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    if conflict:
        offs.zero_()
    vals = torch.randn(run * n, 128, generator=gen, device=dev).to(dtype)
    before = dict(build.launches)
    out = probes.scatter_rows(offs, vals, rows, run)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_scatter_rows": 1}
    mag = probes.scatter_rows_plain(offs, vals.abs(), rows, run)
    assert bool(((out - probes.scatter_rows_plain(offs, vals, rows, run)).abs()
                 <= 1e-5 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [1, 132])
def test_probe_row_copy_matches_plain(dev, ctas):
    """R at P6's shape (the (T // 8, 128) table, 65,536 rows): within 1e-5 of
    the sum of the magnitudes."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(6)
    tab = torch.randn(762_263, 128, generator=gen, device=dev)
    idx = torch.randint(0, 762_263, (65_536,), generator=gen, device=dev, dtype=torch.int32)
    before = dict(build.launches)
    out = probes.row_copy_sum(tab, idx, ctas)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_row_copy": 1} and out.shape == (1, 1)
    mag = tab[idx.long(), 0].abs().sum()
    assert float((out - probes.row_copy_sum_plain(tab, idx)).abs()) <= 1e-5 * float(mag)


@pytest.mark.cuda
def test_probe_strided_permute_and_capacity_match_plain(dev):
    """M at P7's shape, exactly (0/1 permutation); C at the card's ladder,
    exactly, and refused at the TPU's 32 MB."""
    from monosdf_torch.kernels import probes

    x = torch.randn(8200, 128, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    P = probes.lane_permutation(37, dev)
    before = dict(build.launches)
    out = probes.strided_permute(x, P, 1024)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_strided_permute": 1}
    assert torch.equal(out, probes.strided_permute_plain(x, P, 1024))
    for kb in (32, 64, 128, 227):
        rows = kb * 1024 // 512
        assert torch.equal(probes.capacity(rows, dev), probes.capacity_plain(rows, dev))
    before = dict(build.launches)
    with pytest.raises(probes.Refused, match="cudaFuncSetAttribute"):
        probes.capacity(32 * 1024 * 1024 // 512, dev)
    assert _launched(before) == {}
    lim = probes.device_limits(dev)
    assert lim["sharedMemPerBlockOptin"] >= 227 * 1024 and lim["l2CacheSize"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,extra", [(1, 0), (7, 3), (1000, 0), (1024, 0), (4096, 301),
                                         (8192, 0)])
def test_probe_strided_permute_over_tiles_and_dense_p(dev, n_out, extra):
    """M over ragged last tiles (1, 7, 1000 outputs against 8 rows a CTA)
    and more CTAs than SMs (4096, 8192), x longer than 8 n_out + 1 where
    ``extra`` > 0: with the permutation exactly the plain version; with a
    dense random P within 1e-5 * sum_beta |x| |P| of it entry by entry (float32
    sums in another order); one launch a call, a second call bit-equal."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(n_out)
    x = torch.randn(8 * n_out + 1 + extra, 128, generator=gen, device=dev)
    for P in (probes.lane_permutation(37, dev), torch.randn(128, 128, generator=gen, device=dev)):
        before = dict(build.launches)
        out = probes.strided_permute(x, P, n_out)
        torch.cuda.synchronize()
        assert _launched(before) == {"probe_strided_permute": 1} and out.shape == (n_out, 128)
        assert torch.equal(out, probes.strided_permute(x, P, n_out))
        ref = probes.strided_permute_plain(x, P, n_out)
        if P.count_nonzero() == 128:
            assert torch.equal(out, ref)
        else:
            mag = probes.strided_permute_plain(x.abs(), P.abs(), n_out)
            assert bool(((out - ref).abs() <= 1e-5 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ctas,n,stages", [
    (1, 1000, None), (1, 4097, 32), (7, 1000, None), (7, 7, None), (132, 65_536, None),
    (132, 4097, 384), (264, 65_536, None), (264, 264, 64)])
def test_probe_row_copy_over_ctas_rings_and_slices(dev, ctas, n, stages):
    """R over CTA counts (more CTAs than SMs too), ring depths, slices that
    are no multiple of the ring and one row a CTA: repeated indices and
    indices outside the table (clamped) within 1e-5 of the sum of the
    magnitudes; one launch a call; a second call bit-equal (the completion
    counter is back at 0)."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(n + ctas)
    rows = 5000
    tab = torch.randn(rows, 128, generator=gen, device=dev)
    idx = torch.randint(-50, rows + 50, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[: n // 4] = idx[n // 4: 2 * (n // 4)]  # repeats
    before = dict(build.launches)
    out = probes.row_copy_sum(tab, idx, ctas, stages)
    again = probes.row_copy_sum(tab, idx, ctas, stages)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_row_copy": 2} and out.shape == (1, 1)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    mag = tab[idx.long().clamp(0, rows - 1), 0].abs().sum()
    assert float((out - probes.row_copy_sum_plain(tab, idx)).abs()) <= 1e-5 * float(mag)


def _sorted_offs(dev, n, rows, run, gen):
    """n nondecreasing offsets in [0, rows - run] with ties and gaps, the
    first at 0 and the last at rows - run."""
    offs = torch.randint(0, rows - run + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    offs = torch.sort(offs)[0]
    if n >= 4:
        offs[0], offs[-1] = 0, rows - run
        offs[1] = offs[2]  # a tie
    return offs


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,run,dtype", [
    (512, 4096, 8, torch.float32), (512, 4096, 8, torch.bfloat16), (300, 1003, 1, torch.float32),
    (40, 1003, 8, torch.float32), (3000, 1003, 8, torch.bfloat16), (0, 64, 8, torch.float32)])
def test_probe_scatter_rows_sorted_pass(dev, n, rows, run, dtype):
    """S's output-stationary pass on sorted runs (ties, gaps, offsets at 0
    and rows - run, a ragged last block, no runs at all): one launch, the
    plain version's bits on the CPU (the same adds in run order), rows no
    run reaches exactly 0, and a second call bit-equal."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(n + rows + run)
    offs = _sorted_offs(dev, n, rows, run, gen)
    vals = torch.randn(run * n, 128, generator=gen, device=dev).to(dtype)
    before = dict(build.launches)
    out = probes.scatter_rows(offs, vals, rows, run, sorted_offs=True)
    again = probes.scatter_rows(offs, vals, rows, run, sorted_offs=True)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_scatter_rows": 2}
    ref = probes.scatter_rows_plain(offs.cpu(), vals.cpu(), rows, run)
    assert torch.equal(out.cpu(), ref) and torch.equal(out, again)
    reached = torch.zeros(rows, dtype=torch.bool)
    reached[probes.run_rows(offs.cpu(), run)] = True
    assert bool((out.cpu()[~reached] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,run,dtype,conflict,span", [
    (100_352, 65_536, 1, torch.float32, False, None), (100_352, 65_536, 1, torch.bfloat16, True, None),
    (100_352, 65_536, 1, torch.float32, True, 7), (5000, 4096, 8, torch.bfloat16, False, 1),
    (5000, 64, 8, torch.float32, False, 1000), (0, 64, 1, torch.float32, False, None)])
def test_probe_scatter_rows_atomic_pass(dev, n, rows, run, dtype, conflict, span):
    """S's atomic pass on offsets in any order, all-conflict ones (every
    value row into row 0) and some outside [0, rows - run] (which add
    nothing), over span lengths: one launch, per entry within 1e-5 of the
    sum of the magnitudes of its terms."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(n + rows + run)
    offs = torch.randint(0, rows - run + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    if conflict:
        offs.zero_()
    elif n:
        offs[::97] = -1
        offs[5::97] = rows - run + 1
    vals = torch.randn(run * n, 128, generator=gen, device=dev).to(dtype)
    kw = {} if span is None else {"span": span}
    before = dict(build.launches)
    out = probes.scatter_rows(offs, vals, rows, run, **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_scatter_rows": 1}
    keep = (offs >= 0) & (offs <= rows - run)
    vals_in = vals.view(n, run, 128)[keep].reshape(-1, 128)
    ref = probes.scatter_rows_plain(offs[keep], vals_in, rows, run)
    mag = probes.scatter_rows_plain(offs[keep], vals_in.abs(), rows, run)
    assert bool(((out - ref).abs() <= 1e-5 * mag).all())


@pytest.mark.cuda
def test_probe_scatter_rows_sorted_pass_fails_on_unsorted_offsets(dev):
    """Descending offsets given to the sorted pass end its launch with an
    error at the next sync (in a child process: the trap ends the CUDA
    context), never with a result."""
    child = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})\n"
        "from monosdf_torch.kernels import probes\n"
        "offs = torch.tensor([0, 9, 4, 12], dtype=torch.int32, device='cuda')\n"
        "vals = torch.ones(32, 128, device='cuda')\n"
        "out = probes.scatter_rows(offs, vals, 64, 8, sorted_offs=True)\n"
        "torch.cuda.synchronize()\n"
        "print('SILENT', float(out.sum()))\n")
    child_run = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                                timeout=300)
    assert child_run.returncode != 0 and "SILENT" not in child_run.stdout
    assert "CUDA" in child_run.stderr or "cuda" in child_run.stderr, child_run.stderr[-2000:]


# -- the mesh export: the SDF grid through K1 (and K6) -------------------------

def _mesh_models(dev, grid: bool):
    """A small model for the mesh export (the 4x48 MLP on PE(6), or a 2x48
    grid trunk on [PE(6) | 6 levels x 2 features], 51 wide, bf16 table)
    with 0.05 seeded noise on every parameter, and its config on the kernel
    backends and on the plain ones."""
    import dataclasses

    from monosdf_torch.models.monosdf import MonoSDFConfig, init_monosdf

    imp = IMP_PE
    if grid:
        imp = ImplicitNetConfig(feature_vector_size=32, dims=(48, 48), multires=6, use_grid=True,
                                divide_factor=1.1, sdf_bounding_sphere=0.0,
                                grid=_grid_cfg("bfloat16"))
    cfg = MonoSDFConfig(implicit=imp, rendering=REN, sampler_backend="pallas")
    model = init_monosdf(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(dev))
    return model, cfg, dataclasses.replace(cfg, sampler_backend="jnp")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True], ids=["mlp", "grid"])
def test_mesh_sdf_fn_through_k1_matches_plain(dev, grid):
    """meshing.mesh_sdf_fn on the kernel backends (K1 at float32, in grid
    mode on K6's features of every level) against the same function on the
    plain path (fields.sdf_value), 70,000 points: TOL[None]; one K1 launch
    (and one K6) a call."""
    from monosdf_torch.meshing import mesh_sdf_fn

    model, cfg, plain_cfg = _mesh_models(dev, grid)
    x = _rand(dev, 70_000, 3)
    with torch.inference_mode():
        fn = mesh_sdf_fn(model, cfg)
        torch.cuda.synchronize()
        before = dict(build.launches)
        out = fn(x)
        torch.cuda.synchronize()
        counts = {k: build.launches[k] - before[k] for k in before}
        ref = mesh_sdf_fn(model, plain_cfg)(x)
    assert out.dtype == torch.float32 and out.shape == (70_000,)
    _check([out], [ref], None)
    assert counts == {**dict.fromkeys(before, 0), "sdf_mlp": 1,
                      **({"hash_encode": 1} if grid else {})}


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True], ids=["mlp", "grid"])
def test_mesh_extraction_at_128_launches_once_a_call(dev, grid):
    """extract_mesh at 128^3 (one crop, the pyramid) of the kernel path:
    K1's launches (and K6's) equal the SDF callable's calls, no other kernel
    launches; the mesh against the plain path's: face counts within 0.1%,
    the symmetric mean nearest-vertex distance within 1e-2 of a cell."""
    from scipy.spatial import cKDTree

    from monosdf_torch.meshing import extract_mesh, mesh_sdf_fn

    model, cfg, plain_cfg = _mesh_models(dev, grid)
    inner = mesh_sdf_fn(model, cfg)
    calls = [0]

    def fn(pts):
        calls[0] += 1
        return inner(pts)

    fn.device = inner.device
    torch.cuda.synchronize()
    before = dict(build.launches)
    before_ref = dict(build.reference_launches)
    stats = {}
    v, f = extract_mesh(fn, resolution=128, stats=stats)
    torch.cuda.synchronize()
    counts = {k: build.launches[k] - before[k] for k in before}
    assert calls[0] > 1 and stats["marcher"] == "native" and 0 < stats["points"] < 129**3
    assert counts == {**dict.fromkeys(before, 0), "sdf_mlp": calls[0],
                      **({"hash_encode": calls[0]} if grid else {})}
    assert dict(build.reference_launches) == before_ref
    vp, fp = extract_mesh(mesh_sdf_fn(model, plain_cfg), resolution=128)
    assert len(f) > 0 and abs(len(f) - len(fp)) <= 1e-3 * len(fp)
    dist = 0.5 * (cKDTree(vp).query(v)[0].mean() + cKDTree(v).query(vp)[0].mean())
    assert dist <= 1e-2 * 2.2 / 128


@pytest.mark.cuda
def test_mesh_export_raises_when_the_native_build_fails(dev, monkeypatch):
    """No quiet fallback to the numpy marcher: a compiler that fails makes
    the card's mesh export raise, with the compiler's exit in the message."""
    from monosdf_torch.meshing import extract_mesh, mesh_sdf_fn

    model, cfg, _ = _mesh_models(dev, False)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building marching_tets.cpp failed"):
        extract_mesh(mesh_sdf_fn(model, cfg), resolution=32)


# -- the conf path ---------------------------------------------------------

# a shipped conf at full width on a 32x32 scene of 3 views, run for 3 steps
# (the overlay cuts the run length and the images only)
CONF_CASES = {
    "union": ("confs/synth_union_quality.conf", ["--shape", "union"]),
    "grid": ("confs/synth_sphere_quality_grids.conf", ["--shape", "sphere"]),
    "hdr": ("confs/synth_union_hdr.conf", ["--shape", "union", "--hdr"]),
}
_CONF_RUNS: dict = {}


def _conf_run(dev, tmp_path_factory, case):
    """(Trainer after cli/train.py --conf, launches of that call): one run
    a case, cached for the module."""
    if case not in _CONF_RUNS:
        from monosdf_torch.cli import train as ctrain
        from monosdf_torch.scripts import make_synthetic_scene

        conf, gen_args = CONF_CASES[case]
        root = tmp_path_factory.mktemp(f"conf_{case}")
        make_synthetic_scene.main([str(root / "data"), "--n", "3", "--res", "32", *gen_args])
        overlay = root / "cut.conf"
        overlay.write_text("train{ max_total_iters = 3, checkpoint_freq = 100, plot_freq = 0 }\n"
                           "plot{ resolution = 32 }\ndataset{ img_res = [32, 32] }\n")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        trainer = ctrain.main(["--conf", str(Path(__file__).resolve().parent.parent / conf),
                               "--conf_add", str(overlay), "--data_root", str(root / "data"),
                               "--exps_root", str(root / "exps"), "--device", str(dev)])
        torch.cuda.synchronize()
        _CONF_RUNS[case] = (trainer, {k: v for k, v in build.launches.items() if v},
                            dict(build.reference_launches))
    return _CONF_RUNS[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONF_CASES))
def test_conf_run_launches_the_routed_kernels(dev, tmp_path_factory, monkeypatch, case):
    """cli/train.py --conf (steps, the closing validation render and mesh):
    every kernel config.routed_kernels names launches, no other, and the
    order references none; the HDR conf (specular head) runs no K3, the
    grid conf's encoding group its conf's 1.0x rate."""
    from monosdf_torch.config import routed_kernels

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer, launched, refs = _conf_run(dev, tmp_path_factory, case)
    cfg = trainer.exp.model
    assert trainer.step == 3 and set(launched) == set(routed_kernels(cfg)), launched
    assert not any(refs.values())
    if case == "hdr":
        assert cfg.rendering.spec and "radiance_norm" not in launched
    if case == "grid":
        lrs = {id(p): g["lr"] for g in trainer.optimizer.adam.param_groups for p in g["params"]}
        imp = trainer.model.implicit
        assert lrs[id(imp.encoding.embeddings)] == lrs[id(imp.lin0.b)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["union", "grid"])
def test_conf_step_matches_plain_at_fixed_samples(dev, tmp_path_factory, monkeypatch, case):
    """The conf's model (perturbed) at one batch of its run, samples and
    eikonal points fixed: the loss and every gradient with the kernels
    against each kernel's plain version, at chip_smoke.py's bf16 step bars
    (chip_smoke.step_check, which exits on a miss)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer, _, _ = _conf_run(dev, tmp_path_factory, case)
    exp = trainer.exp
    check, counts = chip_smoke.step_check(f"conf {case}", exp.model,
                                          trainer.sample_batch(exp.num_pixels), "bfloat16",
                                          dev, exp.loss)
    assert check["worst_grad_ratio"] <= 1.0
    step_kernels = (("hash_encode", "sdf_grad_grid", "sdf_grad_grid_bwd", "hash_encode_bwd")
                    if case == "grid" else ("sdf_grad", "sdf_grad_bwd", "radiance_norm",
                                            "radiance_norm_bwd"))
    assert all(counts[k] for k in step_kernels), counts


@pytest.mark.cuda
def test_metrics_writer_logs_images_without_pil(dev, tmp_path):
    """Where tensorboard imports (the card's machine has it), the metrics
    writer logs the dashboards' images as PNGs it encodes itself: no PIL
    (nor cv2 or matplotlib) is imported, and the logged PNG decodes to the
    image (the port's PNG reader)."""
    code = (
        "import sys, numpy as np\n"
        "from monosdf_torch.viz import MetricsWriter\n"
        "from monosdf_torch.data.png import read_png\n"
        f"w = MetricsWriter({str(tmp_path)!r})\n"
        "if w._tb is None:\n"
        "    print('NO_TENSORBOARD'); sys.exit(0)\n"
        "img = (np.arange(5 * 7 * 3) % 251).astype(np.uint8).reshape(5, 7, 3)\n"
        "w.scalars({'loss': 0.5}, 1); w.image('x', img, 1); w.close()\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'PIL', 'cv2', 'matplotlib'})\n"
        "assert not bad, bad\n"
        "from tensorboard.backend.event_processing.event_accumulator import EventAccumulator\n"
        f"ea = EventAccumulator({str(tmp_path)!r}, size_guidance={{'images': 0}}); ea.Reload()\n"
        "png = ea.Images('x')[0].encoded_image_string\n"
        f"open({str(tmp_path / 'x.png')!r}, 'wb').write(png)\n"
        f"assert np.array_equal(read_png({str(tmp_path / 'x.png')!r}), img)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True,
                         cwd=str(Path(__file__).resolve().parent.parent)).stdout
    if "NO_TENSORBOARD" in out:
        pytest.skip("tensorboard is not installed")
    assert "OK" in out


def _analytic_mesh(res=48, radius=0.5):
    from monosdf_torch.meshing.marching import marching_tetrahedra, weld_vertices

    xs = np.linspace(-0.8, 0.8, res, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    v, f = marching_tetrahedra(np.linalg.norm(g, axis=-1) - radius,
                               origin=np.full(3, -0.8, np.float32), spacing=xs[1] - xs[0])
    return weld_vertices(v, f)


def _look_at_ring(n=6, dist=2.0):
    poses = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([dist * np.sin(ang), 0.3, -dist * np.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        pose = np.eye(4)
        pose[:3, :3] = np.stack([x, np.cross(z, x), z], axis=-1)
        pose[:3, 3] = eye
        poses.append(pose)
    return poses


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [65536, 777])
def test_rasterizer_on_the_card_matches_cpu(dev, chunk):
    """The z-buffer on the card against the CPU's: the same covered pixels
    (at most 2 edge pixels apart, tests/test_torch_mesh_eval.py's
    allowance), depth within 1e-5 relative; at 64x80 and 480x640 (faces
    subdivided on the host), whole chunks and a ragged tail."""
    from monosdf_torch.mesh_eval import rasterize_depth

    verts, faces = _analytic_mesh()
    for H, W, f in ((64, 80, 90.0), (480, 640, 600.0)):
        K = np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        for pose in _look_at_ring(3):
            a = rasterize_depth(verts, faces, K, pose, H, W, chunk=chunk, device="cpu")
            b = rasterize_depth(verts, faces, K, pose, H, W, chunk=chunk, device=dev)
            assert int(((a > 0) != (b > 0)).sum()) <= 2
            both = (a > 0) & (b > 0)
            assert both.sum() > 0.05 * a.size
            np.testing.assert_allclose(b[both], a[both], rtol=1e-5)


@pytest.mark.cuda
def test_tsdf_refuse_and_dilation_on_the_card_match_cpu(dev):
    """The TSDF volume on the card against the CPU's after 6 views (each
    product and sum rounded once on both: equal but for a voxel whose
    pixel flipped, 1e-3 of them), the refused meshes' vertex counts within
    1% and mean nearest-vertex distance within 1e-3 of a voxel; the mask
    dilation bit for bit."""
    from scipy.ndimage import binary_dilation as scipy_dilation
    from scipy.spatial import cKDTree

    from monosdf_torch.mesh_eval import TSDFVolume, rasterize_depth, refuse_mesh
    from monosdf_torch.mesh_eval.cull import binary_dilation, disk_structure

    verts, faces = _analytic_mesh()
    K = np.array([[60.0, 0, 32, 0], [0, 60.0, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    poses = _look_at_ring()
    vols = {}
    for d in ("cpu", dev):
        vol = TSDFVolume(verts.min(0) - 0.05, verts.max(0) + 0.05, 0.02, device=d)
        for pose in poses:
            vol.integrate(rasterize_depth(verts, faces, K, pose, 64, 64, device="cpu"), K, pose)
        vols[str(d)] = vol
    a, b = vols["cpu"], vols[str(dev)]
    for x, y in ((a.tsdf, b.tsdf), (a.weight, b.weight)):
        assert (torch.abs(x - y.cpu()) > 1e-5).float().mean() <= 1e-3
    va, fa = refuse_mesh(verts, faces, [K] * 6, poses, 64, 64, voxel=0.02, device="cpu")
    vb, fb = refuse_mesh(verts, faces, [K] * 6, poses, 64, 64, voxel=0.02, device=dev)
    assert len(vb) == pytest.approx(len(va), rel=0.01) and len(va) > 100
    d = 0.5 * (cKDTree(va).query(vb)[0].mean() + cKDTree(vb).query(va)[0].mean())
    assert d <= 1e-3 * 0.02
    m = np.random.default_rng(0).uniform(size=(96, 128)) > 0.98
    for r in (0, 3, 12):
        np.testing.assert_array_equal(binary_dilation(m, disk_structure(r), device=dev),
                                      scipy_dilation(m, structure=disk_structure(r)))

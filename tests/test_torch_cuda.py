"""The port's CUDA kernels against their plain versions, on a card.

Needs a CUDA device and nvcc; skips without a card. It imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small widths (4x48 SDF MLP with a skip at 2, multires 4; 2x48 radiance
MLP, with codes of 8 for K3, K8a and K8b; a 6-level hash grid and a 2x48
grid trunk on its 71-wide input) and a few hundred points; the full-width
shapes are chip_smoke.py's.
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
        dws, dbs, dg, df, _ = radiance_norm_bwd(rws, rbs, g, sv, feat, co, cn, dtype)
        dws_p, dbs_p, dg_p, df_p, _ = radiance_norm_bwd_plain(rws, rbs, g, sv, feat, co, cn,
                                                              dtype)
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
        **dict.fromkeys(before, 0), "sdf_grad": 1, "radiance_norm": 1, "sdf_grad_bwd": 1,
        "radiance_norm_bwd": 1}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k7_forward_and_backward_match_plain(dev, dtype):
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
    a0 = t(rng.normal(size=(4, 700, 71)))
    sdf, feat, grad, zs = _forward(ws, bs, a0, dtype, True)
    ref = sdf_mlp_with_grad_in_plain(ws, bs, a0, dtype, True)
    _check([sdf, feat, grad, *zs], [*ref[:3], *ref[3]], dtype)
    cots = [t(rng.normal(size=(700, k))) for k in (1, 32, 3)]
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
@pytest.mark.parametrize("rows,n,axis,dtype,where", [
    (8, 8, 0, torch.float32, "shared"), (8192, 8192, 0, torch.float32, "l2"),
    (512, 512, 1, torch.float32, "shared"), (32768, 2048, 0, torch.bfloat16, "l2")])
def test_probe_gather_matches_plain(dev, rows, n, axis, dtype, where):
    """G at P1's and P8's shapes, exactly: the same float32 adds in order."""
    from monosdf_torch.kernels import probes

    gen = torch.Generator(device=dev).manual_seed(rows + axis)
    tbl = torch.randn(rows, 128, generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, rows if axis == 0 else 128, (n, 128), generator=gen, device=dev,
                        dtype=torch.int32)
    before, seen = dict(build.launches), []
    out = probes.gather(tbl, idx, axis, 32, seen)
    torch.cuda.synchronize()
    assert _launched(before) == {"probe_gather": 1} and seen == [where]
    assert torch.equal(out, probes.gather_plain(tbl, idx, axis, 32))


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

"""Each kernel's plain version against the JAX package: its Pallas kernel
(interpret mode on the CPU, as the JAX package's own tests run it) and its
jnp path. The wrappers take the plain version on CPU tensors; the CUDA
kernels themselves are held against their plain versions on a card by
tests/test_torch_cuda.py.

float32 tolerance 2e-5 per component; each bf16 case states its own.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.models.fields as jf
import monosdf_tpu.ops.pallas_rgb_grad as jrgb
import monosdf_tpu.ops.pallas_sdf_grad as jsdf
import monosdf_tpu.ops.sampler as js
from monosdf_tpu.ops.density import laplace_density as jlaplace
from monosdf_tpu.ops.pallas_mlp import (
    effective_linear_weights,
    fused_sdf_mlp,
    fused_sdf_mlp_nograd,
)
from monosdf_tpu.ops.pallas_sampler import sampler_iter_machinery as jmachinery
import monosdf_torch.models.fields as tf
from monosdf_torch.kernels import build
from monosdf_torch.kernels.radiance_norm import (
    radiance_norm,
    radiance_norm_bwd,
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
from monosdf_torch.kernels.sdf_grad_grid import (
    sdf_mlp_with_grad_in,
    sdf_mlp_with_grad_in_bwd_plain,
    sdf_mlp_with_grad_in_plain,
)
from monosdf_torch.kernels import sdf_mlp as k1
from monosdf_torch.kernels.sdf_mlp import sdf_mlp, sdf_mlp_plain
from monosdf_torch.ops.embedder import positional_encoding
from monosdf_torch.params import flatten_tree
from torch_parity import both_models, configs, jit_ref

torch.set_num_threads(2)  # leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)
JDT = {"float32": None, "bfloat16": jnp.bfloat16}
TDT = {"float32": None, "bfloat16": torch.bfloat16}


def _f32(*shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **{**TOL, **kw})


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs(True)
    jparams, model, _ = both_models(jcfg, tcfg)
    return jcfg, tcfg, jparams, model


def _points(n=200, seed=0):
    return _f32(n, 3, lo=-1.15, hi=1.15, seed=seed)  # some beyond the 1.1 sphere


# -- K1: sdf_mlp ---------------------------------------------------------------
# K1 takes the (N, d0) positional embedding, not raw xyz, as the bench's
# sweeps do (sweep_pe_in_kernel=False); the last layer is cut to the SDF column.

def _k1_inputs(models, x):
    """Port-side effective weights (last layer cut to the SDF column) and
    the embedding of x."""
    jcfg, _, _, model = models
    tws, tbs = tf.effective_linear_weights(model.implicit)
    tws[-1], tbs[-1] = tws[-1][:, :1], tbs[-1][:1]
    tws, tbs = [w.detach() for w in tws], [b.detach() for b in tbs]
    emb = positional_encoding(torch.from_numpy(x), jcfg.implicit.multires)
    return tws, tbs, emb


# bf16: the output is rounded to bf16 (|sdf| < 2, ulp <= 2^-7 = 7.8e-3) and
# float32 sums in another order can round an activation to the neighbouring
# bf16 value; two output ulps bound the difference.
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", dict(atol=1.6e-2))])
def test_k1_plain_matches_pallas(models, dtype, tol):
    jcfg, _, jparams, _ = models
    tws, tbs, emb = _k1_inputs(models, _points())
    skip = jcfg.implicit.skip_in

    def jax_k1(p, e):
        jws, jbs = effective_linear_weights(p, jcfg.implicit.num_layers)
        jws[-1], jbs[-1] = jws[-1][:, :1], jbs[-1][:1]
        return fused_sdf_mlp(jws, jbs, e, skip, block=128, dtype=JDT[dtype])

    out_j = jit_ref(jax_k1)(jparams["implicit"], jnp.asarray(emb.numpy()))
    _close(sdf_mlp_plain(tws, tbs, emb, skip, TDT[dtype]), out_j, **tol)


# K1-PE: the raw points, the embedding computed in the kernel (kernel_pe) in
# float32 and rounded before layer 0, the skip layer's copy / sqrt 2 from
# float32 as well; tolerances as above.
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", dict(atol=1.6e-2))])
def test_k1_pe_plain_matches_pallas(models, dtype, tol):
    jcfg, _, jparams, _ = models
    tws, tbs, _ = _k1_inputs(models, _points())
    x = _points(seed=7)
    imp = jcfg.implicit

    def jax_k1_pe(p, pts):
        jws, jbs = effective_linear_weights(p, imp.num_layers)
        jws[-1], jbs[-1] = jws[-1][:, :1], jbs[-1][:1]
        return fused_sdf_mlp_nograd(jws, jbs, pts, imp.skip_in, block=128, dtype=JDT[dtype],
                                    multires=imp.multires)

    out_j = jit_ref(jax_k1_pe)(jparams["implicit"], jnp.asarray(x))
    out = k1.sdf_mlp_pe_plain(tws, tbs, torch.from_numpy(x), imp.multires, imp.skip_in,
                              TDT[dtype])
    _close(out, out_j, **tol)
    # the wrapper takes the plain version on a CPU tensor, launching nothing
    before = dict(build.launches)
    assert torch.equal(k1.sdf_mlp_pe(tws, tbs, torch.from_numpy(x), imp.multires, imp.skip_in,
                                     TDT[dtype]), out)
    assert build.launches == before


def _mirror_read(wb, off, K, N, kc):
    """The (K, N) B operand the kernels' weight stages read from ``wb`` at
    ``off``: chunk k // kc, element (n, k % kc) at core_offset(n, k % kc,
    256) (csrc/wgmma.cuh), as the kernels address shared memory."""
    k = torch.arange(K)[:, None]
    n = torch.arange(N)[None, :]
    kl = k % kc
    idx = off + (k // kc) * kc * k1.WG_N + ((kl // 8) * (k1.WG_N // 8) + n // 8) * 64 \
        + (n % 8) * 8 + kl % 8
    assert all(k1.core_offset(r, c, 256) == ((c // 8) * 32 + r // 8) * 64 + (r % 8) * 8 + c % 8
               for r, c in ((0, 0), (9, 17), (255, 63)))
    return wb[idx].float()


@pytest.mark.parametrize("case", ["mlp-39", "grid-71", "k2f-mlp-39", "k7b-grid-71", "k7f-grid-71",
                                  "k3b-radiance-289", "k3b-radiance-321"])
def test_bf16_weight_packer_reads_back_every_layer(case):
    """The tensor-core kernels' bf16 weights, read back through a mirror of
    their shared-memory addressing, are the bf16-rounded weights of every
    layer: K1's (64 input rows a ring stage) and K2b's (W_l[:nprev]^T, 32
    rows a stage) for the bench MLP (39-wide input, the skip layer's 217 +
    39 = 256) and the grid trunk (71-wide [PE | features]); K2f's (K1's and
    the last layer's 256 feature columns) for the bench MLP, and K7f's (the
    same packing, the 71 input rows zero-padded to the ring's 128) for the
    grid trunk; K7b's (K2b's and W_0^T, whose 71 columns are zero-padded to
    the product's 256) for the grid trunk; K3b's (W_l, W_1^T and W_0^T's
    rows with a cotangent output in blocks, 64 rows a stage) for the bench's
    289-wide and the appearance-code model's 321-wide radiance input, each
    block's route table naming the segment column of every row."""
    if case.startswith("k3b"):
        return _check_k3b_packing(int(case[-3:]))
    from monosdf_torch.cli.eval import bench_config
    from monosdf_torch.kernels.sdf_grad import BWD_KC, pack_bwd, pack_fwd

    grids = case.endswith("71")
    cfg = bench_config(grids)
    imp = tf.init_implicit_net(cfg.implicit, torch.Generator().manual_seed(0))
    full_ws = [w.detach() for w in tf.effective_linear_weights(imp)[0]]
    L = len(full_ws)
    bwd_mats = {l: full_ws[l][:full_ws[l - 1].shape[1]].t() for l in range(1, L)}
    if case in ("k2f-mlp-39", "k7f-grid-71"):
        wb, offs = pack_fwd(full_ws)
        mats, kc = {**dict(enumerate(full_ws[:-1])), L - 1: full_ws[-1][:, 1:]}, k1.K1_KC
        assert mats[L - 1].shape == (256, 256)
        d0 = full_ws[0].shape[0]
        assert not _mirror_read(wb, offs[0], -(-d0 // kc) * kc, k1.WG_N, kc)[d0:].any()
    elif case == "k7b-grid-71":
        wb, offs = pack_bwd(full_ws, layer0=True)
        mats, kc = {0: full_ws[0].t(), **bwd_mats}, BWD_KC
        assert mats[0].shape == (256, 71)
        assert not _mirror_read(wb, offs[0], 256, k1.WG_N, kc)[:, 71:].any()
    else:
        ws, bs, packed = tf.sweep_weights(imp, cfg.implicit)
        widths = [w.shape[0] for w in ws]
        assert widths[0] == (71 if grids else 39) and (grids or (217 + 39) in widths)
        k1_offs = list(packed.wb_off)
        for l, w in enumerate(ws[:-1]):
            assert torch.equal(_mirror_read(packed.wb, k1_offs[l], *w.shape, k1.K1_KC),
                               w.detach().bfloat16().float()), l
        wb, offs = pack_bwd(full_ws)
        mats, kc = bwd_mats, BWD_KC
    for l, m in mats.items():
        assert torch.equal(_mirror_read(wb, offs[l], *m.shape, kc), m.bfloat16().float()), l


@pytest.mark.parametrize("case", ["k2f-chunk-small-27", "k2f-chunk-mlp-39", "k2f-chunk-union-39",
                                  "k3f-radiance-289", "k3f-radiance-321"])
def test_render_chunk_and_k3f_weight_packers_read_back(case):
    """K2f's render chunk kernel's weights (``pack_chunk``: each hidden W_l,
    then the last layer's feature columns, as float32 of their bf16
    roundings, 16-row ring stages of 256 columns, zero-padded; then the SDF
    column) for a 48-wide test trunk (27-wide input, padded to 32) and the
    bench's and the union model's 8x256 trunks; K3f's bf16 B operands
    (``pack_fwd``: W_0 and W_1, read back through the mirror of the kernels'
    shared-memory addressing) for the 289-wide and the 321-wide (with
    codes) radiance input, the first operands of K3b's ``pack_bwd``."""
    from monosdf_torch.cli.eval import bench_mlp_config, union_codes_config

    if case.startswith("k3f"):
        from monosdf_torch.kernels.radiance_norm import BWD_KC, pack_bwd, pack_fwd

        d0 = int(case[-3:])
        cfg = (union_codes_config() if d0 == 321 else bench_mlp_config()).rendering
        ren = tf.init_rendering_net(cfg, torch.Generator().manual_seed(0))
        ws = [w.detach() for w in tf.effective_linear_weights(ren)[0]]
        assert ws[0].shape[0] == d0
        wb, offs = pack_fwd(ws)
        assert len(offs) == len(ws) - 1
        for l, w in enumerate(ws[:-1]):
            assert torch.equal(_mirror_read(wb, offs[l], *w.shape, BWD_KC), w.bfloat16().float())
        C = cfg.code_dim if cfg.per_image_code else 0
        widths = (d0 - 3 - cfg.feature_vector_size - C, 3, cfg.feature_vector_size, C)
        wb_bwd, offs_bwd = pack_bwd(ws, widths, (1, 2, 3) if C else (1, 2))[:2]
        assert offs_bwd[:len(offs)] == offs and torch.equal(wb, wb_bwd[:wb.numel()])
        return
    from monosdf_torch.kernels.sdf_grad import CHUNK_KT, pack_chunk

    which = case.split("-")[2]
    cfg = {"small": tf.ImplicitNetConfig(feature_vector_size=32, dims=(48,) * 4, skip_in=(2,),
                                         multires=4),
           "mlp": bench_mlp_config().implicit, "union": union_codes_config().implicit}[which]
    imp = tf.init_implicit_net(cfg, torch.Generator().manual_seed(0))
    ws = [w.detach() for w in tf.effective_linear_weights(imp)[0]]
    assert ws[0].shape[0] == int(case[-2:])
    wc, offs = pack_chunk(ws)
    L = len(ws)
    assert wc.dtype == torch.float32 and len(offs) == L + 1
    for l, m in enumerate([*ws[:-1], ws[-1][:, 1:]]):
        K, n = m.shape
        kp = -(-K // CHUNK_KT) * CHUNK_KT
        assert offs[l] % (CHUNK_KT * k1.WG_N) == 0  # whole stages, 16-byte aligned
        blk = wc[offs[l]:offs[l] + kp * k1.WG_N].view(kp, k1.WG_N)
        assert torch.equal(blk[:K, :n], m.bfloat16().float()), l
        assert not blk[K:].any() and not blk[:, n:].any()
    assert offs[L] == wc.numel() - ws[-1].shape[0]
    assert torch.equal(wc[offs[L]:], ws[-1][:, 0].bfloat16().float())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k2f_simt_reference_takes_plain_on_cpu(dtype):
    """K2f's order reference (the SIMT kernel on a card) is the plain
    version on a CPU tensor, as the main wrapper is, and launches nothing."""
    from monosdf_torch.kernels.sdf_grad import sdf_mlp_with_grad_simt

    cfg = tf.ImplicitNetConfig(feature_vector_size=32, dims=(48,) * 4, skip_in=(2,), multires=4)
    imp = tf.init_implicit_net(cfg, torch.Generator().manual_seed(0))
    ws, bs = ([t.detach() for t in ts] for ts in tf.effective_linear_weights(imp))
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1.3, 1.3, (37, 3)).astype(np.float32))
    args = (ws, bs, x, cfg.multires, cfg.skip_in, dtype, 1.1, 1.0)
    before, ref_before = dict(build.launches), dict(build.reference_launches)
    out = sdf_mlp_with_grad_simt(*args)
    for a, b, c in zip(out, sdf_mlp_with_grad(*args), sdf_mlp_with_grad_plain(*args)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert build.launches == before and build.reference_launches == ref_before


def test_k4_order_reference_takes_the_plain_version_on_the_cpu():
    """K4 at depth 1, the speculative kernel's order reference
    (sampler_iter_machinery_seq), takes the plain version on a CPU tensor,
    as the main wrapper does, and launches nothing."""
    from monosdf_torch.kernels.sampler_machinery import sampler_iter_machinery_seq

    rng = np.random.default_rng(3)
    R, N = 5, 64
    z = np.sort(rng.uniform(0.0, 3.0, (R, N)), axis=-1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    sdf = t(np.tanh(1.5 - z) * 0.6)
    dists = np.diff(z, axis=-1)
    dt = t(np.concatenate([dists, np.full((R, 1), 1e10)], -1))
    ds = t(np.concatenate([np.abs(rng.normal(size=(R, N - 1))) * 0.05, np.zeros((R, 1))], -1))
    bp = t(np.sqrt(np.sum(dists**2, -1) / (4 * np.log(1.1)))[:, None])
    before, ref_before = dict(build.launches), dict(build.reference_launches)
    for last in (False, True):
        args = (sdf, dt, ds, bp, torch.tensor(0.01), 0.1, 1e-6, last, 10, None)
        for a, b, c in zip(sampler_iter_machinery_seq(*args), sampler_iter_machinery(*args),
                           sampler_iter_machinery_plain(*args)):
            assert torch.equal(a, b) and torch.equal(a, c)
    assert build.launches == before and build.reference_launches == ref_before


def test_reset_launch_counts_clears_the_reference_count():
    """The smoke counts each main path from 0: the reset clears the kernels'
    counts and the order references' (K2f's SIMT kernel, K4 at depth 1)."""
    saved = dict(build.launches), dict(build.reference_launches)
    try:
        build.launches["sdf_grad"] += 3
        build.reference_launches["sdf_grad_simt"] += 2
        build.reference_launches["sampler_machinery_seq"] += 1
        build.reset_launch_counts()
        assert not any(build.launches.values()) and build.reference_launches == {
            "sdf_grad_simt": 0, "sampler_machinery_seq": 0}
    finally:
        build.launches.update(saved[0])
        build.reference_launches.update(saved[1])


def _check_k3b_packing(d0):
    from monosdf_torch.cli.eval import bench_mlp_config, union_codes_config
    from monosdf_torch.kernels.radiance_norm import BWD_KC, pack_bwd

    cfg = (union_codes_config() if d0 == 321 else bench_mlp_config()).rendering
    ren = tf.init_rendering_net(cfg, torch.Generator().manual_seed(0))
    ws = [w.detach() for w in tf.effective_linear_weights(ren)[0]]
    F, C = cfg.feature_vector_size, cfg.code_dim if cfg.per_image_code else 0
    widths = (d0 - 3 - F - C, 3, F, C)
    assert ws[0].shape[0] == d0 and len(ws) == 3
    wb, offs, ks, nblk, route = pack_bwd(ws, widths, (1, 2, 3) if C else (1, 2))
    # each block's W0^T rows, rebuilt from its route table: (segment << 16)
    # | column, every output column once, the columns with an output first
    starts = [0, widths[0], widths[0] + 3, widths[0] + 3 + F]
    blocks, seen = [], []
    for b in range(nblk):
        codes = [int(v) for v in route[b] if v >= 0]
        assert all(v < 0 for v in route[b, len(codes):])
        seen += codes
        blocks.append(ws[0][[starts[v >> 16] + (v & 0xFFFF) for v in codes]].t())
    assert sorted(seen) == sorted((s << 16) | c for s in (1, 2, 3) for c in range(widths[s]))
    assert nblk == 2 and blocks[0].shape[1] == F
    mats = [ws[0], ws[1], ws[1].t(), *blocks]
    assert ks == [m.shape[0] for m in mats]
    for m, (off, mat) in enumerate(zip(offs, mats)):
        assert torch.equal(_mirror_read(wb, off, *mat.shape, BWD_KC), mat.bfloat16().float()), m
    # padding: W_0's rows past d0 up to the ring's 64-row stages, a block's
    # columns past its width
    assert not _mirror_read(wb, offs[0], -(-d0 // 64) * 64, k1.WG_N, BWD_KC)[d0:].any()
    assert not _mirror_read(wb, offs[4], 256, k1.WG_N, BWD_KC)[:, 3 + C:].any()


@pytest.mark.parametrize("d0", [289, 321], ids=["no-code", "code"])
@pytest.mark.parametrize("way", ["fwd", "bwd"])
def test_k8a_tensor_core_packers_read_back(way, d0):
    """K8a's bf16 B operands, read back through the mirror of the kernels'
    shared-memory addressing, for the bench's 289-wide radiance input and
    the appearance-code model's 321-wide one, at K8a's segments (sv, the
    raw gradient, the features, the code) and the outputs its tensor-core
    backward gives (``radiance_norm.tc_outputs``): the forward's W_0 and
    W_1 (``pack_fwd``, the first operands of ``pack_bwd``); the backward's
    input blocks, whose route tables name every column of dn, df and dc
    exactly once and no column of sv (the points and view PE get no
    cotangent)."""
    from monosdf_torch.cli.eval import bench_mlp_config, union_codes_config
    from monosdf_torch.kernels.radiance_norm import BWD_KC, pack_bwd, pack_fwd, tc_outputs

    cfg = (union_codes_config() if d0 == 321 else bench_mlp_config()).rendering
    F, C = cfg.feature_vector_size, cfg.code_dim if cfg.per_image_code else 0
    widths = (d0 - 3 - F - C, 3, F, C)
    assert widths[0] == 30 and cfg.dims == (256, 256)  # [points, view PE(4)]; 2x256
    ws = [torch.from_numpy(_f32(k, n, seed=k)) for k, n in ((d0, 256), (256, 256), (256, 3))]
    outputs = tc_outputs(widths)
    assert outputs == ((1, 2, 3) if C else (1, 2))
    wb, offs, ks, nblk, route = pack_bwd(ws, widths, outputs)
    if way == "fwd":
        wf, offs_f = pack_fwd(ws)
        assert len(offs_f) == 2 and offs[:2] == offs_f and torch.equal(wf, wb[:wf.numel()])
        for l, w in enumerate(ws[:-1]):
            assert torch.equal(_mirror_read(wf, offs_f[l], *w.shape, BWD_KC), w.bfloat16().float())
        return
    starts = [0, widths[0], widths[0] + 3, widths[0] + 3 + F]
    seen = []
    assert route.dtype == torch.int32 and route.shape == (nblk, k1.WG_N) and nblk == 2
    for b in range(nblk):
        codes = [int(v) for v in route[b] if v >= 0]
        assert all(v < 0 for v in route[b, len(codes):])
        seen += codes
        rows = ws[0][[starts[v >> 16] + (v & 0xFFFF) for v in codes]].t()
        m = len(offs) - nblk + b  # after W_0, W_1 and W_1^T
        assert ks[m] == rows.shape[0]
        assert torch.equal(_mirror_read(wb, offs[m], *rows.shape, BWD_KC),
                           rows.bfloat16().float()), b
    assert not any(v >> 16 == 0 for v in seen)
    assert len(seen) == len(set(seen)) == 3 + F + C
    assert set(seen) == {(s << 16) | c for s in outputs for c in range(widths[s])}


@pytest.mark.parametrize("d0", [283, 315], ids=["no-code", "code"])
def test_k8b_tensor_core_packers_read_back(d0):
    """K8b's bf16 B operands for nerf mode's one-segment input row, [view
    PE(4) | 256 features] (283 wide) and with a 32-wide code (315): its
    input blocks (``input_blocks((d0,), (0,))``) cover each of the d0
    columns exactly once in two blocks of at most 256, the route tables
    name them, and ``pack_bwd``'s W0^T blocks read back through the mirror
    of the kernels' addressing as W0's rows; the forward's operands
    (``pack_fwd``) are ``pack_bwd``'s first two."""
    from monosdf_torch.kernels.radiance_norm import BWD_KC, input_blocks, pack_bwd, pack_fwd

    ws = [torch.from_numpy(_f32(k, n, seed=k)) for k, n in ((d0, 256), (256, 256), (256, 3))]
    blocks = input_blocks((d0,), (0,))
    cols = [c for runs, _ in blocks for a, b in runs for c in range(a, b)]
    assert len(blocks) == 2 and all(len(codes) <= k1.WG_N for _, codes in blocks)
    assert sorted(cols) == list(range(d0)) and [c for _, codes in blocks for c in codes] == cols
    wb, offs, ks, nblk, route = pack_bwd(ws, (d0,), (0,))
    wf, offs_f = pack_fwd(ws)
    assert offs[:2] == offs_f and torch.equal(wf, wb[:wf.numel()])
    assert nblk == 2 and len(offs) == 5 and route.shape == (2, k1.WG_N)
    assert torch.equal(_mirror_read(wb, offs[0], d0, 256, BWD_KC), ws[0].bfloat16().float())
    seen = []
    for b in range(nblk):
        codes = [int(v) for v in route[b] if v >= 0]
        assert all(v < 0 for v in route[b, len(codes):])
        seen += codes
        rows = ws[0][codes].t()  # segment 0: a code is the column itself
        assert ks[3 + b] == rows.shape[0] == 256
        assert torch.equal(_mirror_read(wb, offs[3 + b], 256, len(codes), BWD_KC),
                           rows.bfloat16().float()), b
    assert sorted(seen) == list(range(d0))


@pytest.mark.parametrize("code_dim", [0, 8], ids=["no-code", "code"])
def test_k8a_wrapper_takes_plain_on_cpu_in_bf16(code_dim):
    """On a CPU tensor K8a's wrappers take the plain versions in bf16, as in
    float32: the forward, the backward and the autograd Function's gradients
    equal them, and nothing is launched."""
    from monosdf_torch.kernels import radiance_split as k8a

    cfg = tf.RenderingNetConfig(feature_vector_size=32, dims=(48, 48), multires_view=4,
                                per_image_code=code_dim > 0, code_dim=code_dim or 32)
    ren = tf.init_rendering_net(cfg, torch.Generator().manual_seed(0))
    ws, bs = ([t.detach() for t in ts] for ts in tf.effective_linear_weights(ren))
    n = 37
    t = lambda *shape, seed: torch.from_numpy(_f32(*shape, seed=seed))  # noqa: E731
    normals, feat, co = t(n, 3, seed=1), t(n, 32, seed=2).bfloat16(), t(n, 3, seed=3)
    sv = torch.cat([t(n, 3, seed=4), positional_encoding(t(n, 3, seed=5), 4)], -1)
    code = t(n, code_dim, seed=6) if code_dim else None
    bf = torch.bfloat16
    before = dict(build.launches)
    out = k8a.radiance_split(ws, bs, normals, sv, feat, code, bf)
    assert torch.equal(out, k8a.radiance_split_plain(ws, bs, normals, sv, feat, code, bf))
    bwd = k8a.radiance_split_bwd(ws, bs, normals, sv, feat, code, co, bf)
    ref = k8a.radiance_split_bwd_plain(ws, bs, normals, sv, feat, code, co, bf)
    for a, b in zip([*bwd[0], *bwd[1], *bwd[2:]], [*ref[0], *ref[1], *ref[2:]]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert bwd[3].dtype == bf and bwd[2].dtype == torch.float32
    for x in (normals, feat, *ws):
        x.requires_grad_()
    (k8a.radiance_split(ws, bs, normals, sv, feat, code, bf) * co).sum().backward()
    assert torch.equal(normals.grad, ref[2]) and torch.equal(feat.grad, ref[3].to(bf))
    assert all(torch.equal(w.grad, d) for w, d in zip(ws, ref[0]))
    assert build.launches == before


def test_k1_plain_matches_jnp_path(models):
    jcfg, _, jparams, _ = models
    x = _points(seed=1)
    tws, tbs, emb = _k1_inputs(models, x)
    out_j = jit_ref(lambda p, y: jf.implicit_apply(p, jcfg.implicit, y))(
        jparams["implicit"], jnp.asarray(x))[:, :1]
    _close(sdf_mlp_plain(tws, tbs, emb, jcfg.implicit.skip_in), out_j)


# The grid trunk's sweeps: K1 on [PE(6) | 32 grid features], 71 wide, a 2x32
# trunk without skip; float32 at the 2e-5 bar.
def test_k1_plain_matches_pallas_at_the_grid_width():
    rng = np.random.default_rng(3)
    sizes = (71, 32, 32, 1)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in sizes[1:]]
    emb = _f32(200, 71, seed=4)
    out_j = jit_ref(lambda w, b, e: fused_sdf_mlp(w, b, e, (), block=128))(
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], jnp.asarray(emb))
    tws, tbs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    _close(sdf_mlp(tws, tbs, torch.from_numpy(emb), ()), out_j)
    from monosdf_torch.kernels.sdf_mlp import check_mlp_dims

    check_mlp_dims(tws, (), 71, last_max=4)
    with pytest.raises(ValueError):  # wider than the kernels' 80-column input tile
        check_mlp_dims([torch.zeros(81, 32), *tws[1:]], (), 81, last_max=4)


def test_k1_wrapper_takes_plain_on_cpu(models):
    tws, tbs, emb = _k1_inputs(models, _points(seed=2))
    before = dict(build.launches)
    out = sdf_mlp(tws, tbs, emb, (2,), torch.bfloat16)
    assert torch.equal(out, sdf_mlp_plain(tws, tbs, emb, (2,), torch.bfloat16))
    assert build.launches == before


def test_sweep_weights_resolved_once_give_the_same_sdf(models):
    """A render resolves and packs K1's weights once for all its sweeps."""
    _, tcfg, _, model = models
    x = torch.from_numpy(_points(seed=6))
    ws, bs, packed = weights = tf.sweep_weights(model.implicit, tcfg.implicit)
    assert ws[-1].shape[1] == 1 and packed.desc[0] == len(ws)
    assert packed.P.numel() == sum(t.numel() for t in (*ws, *bs))
    assert packed.wb.dtype == torch.bfloat16
    with torch.no_grad():
        a = tf.sdf_value_pallas(model.implicit, tcfg.implicit, x, weights=weights)
        b = tf.sdf_value_pallas(model.implicit, tcfg.implicit, x)
    assert torch.equal(a, b)


# -- K4: sampler_machinery -----------------------------------------------------

def _k4_inputs(R=8, N=256, seed=0):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 3.85, (R, N)), axis=-1).astype(np.float32)
    surf = rng.uniform(0.8, 2.5, (R, 1))
    sdf = (np.tanh(surf - z) * 0.6 + 0.01 * rng.standard_normal((R, N))).astype(np.float32)
    dists = np.diff(z, axis=-1)
    dists_tail = np.concatenate([dists, np.full((R, 1), 1e10)], -1).astype(np.float32)
    d_star = np.pad(np.asarray(js._d_star(jnp.asarray(z), jnp.asarray(sdf))), ((0, 0), (0, 1)))
    bound = np.sum(dists**2, -1) / (4.0 * np.log(1.1))
    beta_prev = np.sqrt(bound)[:, None].astype(np.float32)
    return z, sdf, dists_tail, d_star.astype(np.float32), beta_prev


def _k4_both(dtype, last, **kw):
    z, sdf, dt, ds, bp = _k4_inputs(**kw)
    beta0 = np.float32(0.01)
    bj, pj = jit_ref(lambda *a: jmachinery(*a, eps=0.1, add_tiny=1e-6, last=last,
                                           beta_iters=10, dtype=JDT[dtype]))(
        *(jnp.asarray(a) for a in (sdf, dt, ds, bp, beta0)))
    bt, pt = sampler_iter_machinery_plain(
        *(torch.from_numpy(np.asarray(a)) for a in (sdf, dt, ds, bp, beta0)),
        eps=0.1, add_tiny=1e-6, last=last, beta_iters=10, dtype=TDT[dtype])
    return (bj, pj), (bt, pt)


@pytest.mark.parametrize("last", [False, True])
def test_k4_plain_matches_pallas_f32(last):
    (bj, pj), (bt, pt) = _k4_both("float32", last)
    _close(bt, bj)
    _close(pt, pj, rtol=1e-4)  # pdf entries reach ~1e3: relative


# bf16: both round the scanned terms to bf16 and sum in float32, but the sums
# run in another order (MXU tree vs a sequential scan), ~1e-6 relative;
# beta is a bisection over 10 halvings of [beta0, beta_prev] and moves by at
# most one halving step when a comparison with eps flips.
def test_k4_plain_matches_pallas_bf16():
    (bj, pj), (bt, pt) = _k4_both("bfloat16", False)
    _, _, _, _, bp = _k4_inputs()
    _close(bt, bj, atol=float(bp.max()) / 2**10)
    _close(pt, pj, rtol=2e-2, atol=1e-5)


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
def test_k4_plain_matches_jnp_machinery(last):
    z, sdf, dt, ds, bp = _k4_inputs(seed=1)
    beta0 = np.float32(0.01)
    bj, pj = jit_ref(lambda *a: _jnp_machinery(*a, 0.1, 1e-6, last, 10))(
        jnp.asarray(sdf), jnp.asarray(z), jnp.asarray(bp[:, 0]), jnp.asarray(beta0))
    bt, pt = sampler_iter_machinery_plain(
        *(torch.from_numpy(np.asarray(a)) for a in (sdf, dt, ds, bp, beta0)),
        eps=0.1, add_tiny=1e-6, last=last, beta_iters=10)
    _close(bt[:, 0], bj)
    if last:
        pt = pt - 1e-5  # the machinery's final pdf is weights + 1e-5
    _close(pt[:, :-1], pj[:, :-1] if last else pj, rtol=1e-4)


def test_k4_wrapper_takes_plain_on_cpu():
    _, sdf, dt, ds, bp = (torch.from_numpy(np.asarray(a)) for a in _k4_inputs(seed=2))
    before = dict(build.launches)
    a = sampler_iter_machinery(sdf, dt, ds, bp, torch.tensor(0.01), 0.1, 1e-6, False)
    b = sampler_iter_machinery_plain(sdf, dt, ds, bp, torch.tensor(0.01), 0.1, 1e-6, False)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert build.launches == before


# -- K2: sdf_grad forward --------------------------------------------------------

# bf16: activations are stored at bf16 between layers in both; a flip of one
# rounding moves sdf and gradient (|grad| ~ 1) by ~1e-2 through 5 layers;
# features are bf16 values ~1 (ulp 2^-7).
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", dict(atol=3e-2))])
def test_k2_plain_matches_pallas(models, dtype, tol):
    jcfg, tcfg, jparams, model = models
    x = _points(160, seed=3)
    out_j = jit_ref(lambda p, y: jf.sdf_feat_grad_pallas(p, jcfg.implicit, y, dtype=JDT[dtype]))(
        jparams["implicit"], jnp.asarray(x))
    with torch.no_grad():  # K2 is forward-only
        out_t = tf.sdf_feat_grad_pallas(model.implicit, tcfg.implicit, torch.from_numpy(x),
                                        dtype=TDT[dtype])
    assert out_t[1].dtype == (TDT[dtype] or torch.float32)
    for a, b in zip(out_t, out_j):
        _close(a, b, **tol)


def test_k2_plain_matches_jnp_path(models):
    jcfg, tcfg, jparams, model = models
    x = _points(160, seed=4)
    out_j = jit_ref(lambda p, y: jf.sdf_feat_grad(p, jcfg.implicit, y))(
        jparams["implicit"], jnp.asarray(x))
    with torch.no_grad():
        out_t = tf.sdf_feat_grad_pallas(model.implicit, tcfg.implicit, torch.from_numpy(x))
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_k2_requires_grad_takes_the_autograd_path():
    """A weight that requires grad routes K2 through its autograd Function
    (plain versions on the CPU): finite gradients, no kernel launch."""
    gen = torch.Generator().manual_seed(0)
    ws = [(0.3 * torch.randn(27, 8, generator=gen)).requires_grad_(),
          (0.3 * torch.randn(8, 5, generator=gen)).requires_grad_()]
    bs = [torch.zeros(8, requires_grad=True), torch.zeros(5, requires_grad=True)]
    x = torch.rand(6, 3, generator=gen) * 2 - 1
    before = dict(build.launches)
    sdf, feat, grad = sdf_mlp_with_grad(ws, bs, x, 4, (), None, 1.1, 1.0)
    assert grad.grad_fn is not None and type(grad.grad_fn).__name__ == "_SdfMlpWithGradBackward"
    (sdf.sum() + feat.sum() + (grad**2).sum()).backward()
    for t in (*ws, *bs):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert build.launches == before


# -- K2 training forward (save_z, clamp_rows, flag) and K2b ---------------------

K2_BLOCK = 64  # the JAX kernel's row block here; 150 points is no multiple of it


def _k2_case(seed=11, n=150, n_eik=20, bounding=0.9):
    """A config with a 0.9 bounding sphere (the clamp fires on points
    outside it), its JAX params and the port's effective weights, and n
    points of which the last n_eik are a folded, unclamped batch."""
    cfg = jf.ImplicitNetConfig(feature_vector_size=32, dims=(48, 48, 48, 48), skip_in=(2,),
                               multires=4, sdf_bounding_sphere=bounding, inside_outside=True,
                               bias=0.9)
    tcfg = tf.ImplicitNetConfig(**{f: getattr(cfg, f) for f in (
        "feature_vector_size", "dims", "skip_in", "multires", "sdf_bounding_sphere",
        "inside_outside", "bias")})
    gen = torch.Generator().manual_seed(seed)
    net = tf.init_implicit_net(tcfg, gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    tws, tbs = (list(t.detach() for t in ts) for ts in tf.effective_linear_weights(net))
    jws, jbs = [jnp.asarray(w.numpy()) for w in tws], [jnp.asarray(b.numpy()) for b in tbs]
    x = _f32(n, 3, lo=-1.3, hi=1.3, seed=seed)
    return cfg, tws, tbs, jws, jbs, x, n - n_eik


@functools.lru_cache(maxsize=None)
def _jax_k2_fwd(dtype, n_main):
    """JAX's K2 training forward (_fwd_pallas with save_z) at _k2_case()'s
    config, jitted: one compile for the tests that run it."""
    cfg = _k2_case()[0]
    return jit_ref(lambda ws, bs, x: jsdf._fwd_pallas(
        ws, bs, x, cfg.skip_in, cfg.multires, JDT[dtype], K2_BLOCK, None, save_z=True,
        bounding_sphere=cfg.sdf_bounding_sphere, clamp_rows=n_main))


def _jax_z_to_port(zs, ws, n, block):
    """The JAX kernel's Z, block i owning rows [4b i, 4b (i+1)) and the
    columns padded to 128, as the port's (4, N, out) layout."""
    out = []
    for z, w in zip(zs, ws):
        z = np.asarray(z.astype(jnp.float32))
        out.append(z.reshape(-1, 4, block, z.shape[1]).transpose(1, 0, 2, 3)
                   .reshape(4, -1, z.shape[1])[:, :n, :w.shape[1]])
    return out


# bf16: the activations are bf16 between layers in both, and float32 sums
# in another order can round one to the neighbouring bf16 value; that moves
# sdf and gradient by ~1e-2 through 5 layers, and a stored Z (|Z| up to ~4)
# by one bf16 ulp, 2^-6.
@pytest.mark.parametrize("dtype,tol,ztol", [("float32", TOL, TOL),
                                            ("bfloat16", dict(atol=3e-2), dict(atol=6.3e-2))])
def test_k2_training_forward_matches_pallas(dtype, tol, ztol):
    cfg, tws, tbs, jws, jbs, x, n_main = _k2_case()
    sdf_j, feat_j, g_j, flag_j, zs_j = _jax_k2_fwd(dtype, n_main)(jws, jbs, jnp.asarray(x))
    sdf_t, feat_t, g_t, flag_t, zs_t = sdf_mlp_with_grad(
        tws, tbs, torch.from_numpy(x), cfg.multires, cfg.skip_in, TDT[dtype],
        cfg.sdf_bounding_sphere, 1.0, clamp_rows=n_main, save_z=True)
    for a, b in ((sdf_t, sdf_j), (feat_t, feat_j), (g_t, g_j)):
        _close(a, b, **tol)
    np.testing.assert_array_equal(_np(flag_t), np.asarray(flag_j))
    assert 0 < int((flag_t[:n_main] == 0).sum()) and bool((flag_t[n_main:] == 1).all())
    assert [z.shape for z in zs_t] == [(4, x.shape[0], w.shape[1]) for w in tws[:-1]]
    assert all(z.dtype == (TDT[dtype] or torch.float32) for z in zs_t)
    for a, b in zip(zs_t, _jax_z_to_port(zs_j, tws, x.shape[0], K2_BLOCK)):
        _close(a, b, **ztol)


def _k2_cotangents(n, F, seed=12):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in ((n, 1), (n, F), (n, 3))]


def _grad_close(dws_t, dbs_t, dws_j, dbs_j, atol, rtol):
    """Per tensor: |a - b| <= atol + rtol * max|b| (sums over the rows)."""
    for a, b in zip([*dws_t, *dbs_t], [*dws_j, *dbs_j]):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(_np(a), b, atol=atol + rtol * float(np.abs(b).max()), rtol=0)


# The same x, Z (the JAX forward's), cotangents and flag into both. float32:
# sums in another order, the repo's kernel parameter-grad bar; bf16: the
# operands are bf16 in both, the float32 sums run in another order over
# ~600 rows, and a rounding can land on the neighbouring bf16 value.
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 2e-4, 1e-3), ("bfloat16", 1e-2, 2e-2)])
def test_k2_backward_matches_pallas(dtype, atol, rtol):
    cfg, tws, tbs, jws, jbs, x, n_main = _k2_case()
    n = x.shape[0]
    _, _, _, flag_j, zs_j = _jax_k2_fwd(dtype, n_main)(jws, jbs, jnp.asarray(x))
    cs, cf, cg = _k2_cotangents(n, cfg.feature_vector_size)
    dws_j, dbs_j = jit_ref(lambda ws, bs, x, zs, cs, cf, cg, flag: jsdf._bwd_pallas(
        ws, bs, x, zs, cs, cf, cg, cfg.skip_in, cfg.multires, JDT[dtype], K2_BLOCK, None,
        flag=flag))(jws, jbs, jnp.asarray(x), zs_j, jnp.asarray(cs), jnp.asarray(cf),
                    jnp.asarray(cg), flag_j)
    zs_t = [torch.from_numpy(z).to(TDT[dtype] or torch.float32)
            for z in _jax_z_to_port(zs_j, tws, n, K2_BLOCK)]
    dws_t, dbs_t = sdf_mlp_with_grad_bwd(
        tws, tbs, torch.from_numpy(x), zs_t, *(torch.from_numpy(c) for c in (cs, cf, cg)),
        cfg.multires, cfg.skip_in, TDT[dtype], flag=torch.from_numpy(np.array(flag_j)))
    _grad_close(dws_t, dbs_t, dws_j, dbs_j, atol, rtol)


def test_k2_backward_recomputes_z_when_not_given():
    cfg, tws, tbs, _, _, x, n_main = _k2_case(seed=13)
    xt = torch.from_numpy(x)
    _, _, _, flag, zs = sdf_mlp_with_grad_plain(tws, tbs, xt, cfg.multires, cfg.skip_in, None,
                                                cfg.sdf_bounding_sphere, 1.0, n_main, True)
    cots = [torch.from_numpy(c) for c in _k2_cotangents(x.shape[0], cfg.feature_vector_size)]
    a = sdf_mlp_with_grad_bwd_plain(tws, tbs, xt, zs, *cots, cfg.multires, cfg.skip_in, flag=flag)
    b = sdf_mlp_with_grad_bwd_plain(tws, tbs, xt, None, *cots, cfg.multires, cfg.skip_in,
                                    flag=flag)
    for u, v in zip([*a[0], *a[1]], [*b[0], *b[1]]):
        assert torch.equal(u, v)


def _k2_loss(s, f, g, tgt, n):
    """tests/test_pallas_sdf_grad.py:77-85's loss, on the first n rows."""
    norm = (g * g).sum(-1) ** 0.5
    return ((s[:n] ** 2).mean() + 0.1 * ((f[:n] - 0.3) ** 2).mean()
            + 0.5 * ((norm - 1.0) ** 2).mean() + abs(g[:n] - tgt[:n]).mean())


def test_k2_autograd_grads_match_jax_grad_and_double_backward():
    """The autograd Function's parameter gradients (K2f with saved Z, K2b;
    plain versions on the CPU) against jax.grad through the JAX Pallas
    path and against torch's double backward of the plain forward, f32 at
    the repo's kernel parameter-grad bar 2e-4 / 1e-3."""
    jcfg, tcfg = configs(True)
    jparams, model, _ = both_models(jcfg, tcfg)
    x = _points(72, seed=1)
    tgt = np.random.default_rng(2).normal(size=(72, 3)).astype(np.float32)
    n = 60  # the last 12 rows: a folded eikonal batch (clamp_rows)

    def jloss(p):
        s, f, g = jf.sdf_feat_grad_pallas(p, jcfg.implicit, jnp.asarray(x), clamp_rows=n)
        return _k2_loss(s, f, g, jnp.asarray(tgt), n)

    gj = jit_ref(jax.grad(jloss))(jparams["implicit"])
    grads = {}
    for name, fn in (("kernel", lambda: tf.sdf_feat_grad_pallas(
            model.implicit, tcfg.implicit, torch.from_numpy(x), clamp_rows=n)),
                     ("plain", lambda: _plain_folded(model, tcfg, x, n))):
        model.zero_grad()
        _k2_loss(*fn(), torch.from_numpy(tgt), n).backward()
        grads[name] = {k: p.grad.clone() for k, p in model.implicit.named_parameters()}
    flat_j = _flat(gj)
    for k, g in grads["kernel"].items():
        np.testing.assert_allclose(_np(g), flat_j[k], atol=2e-4, rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(_np(g), _np(grads["plain"][k]), atol=2e-4, rtol=1e-3,
                                   err_msg=k)


def _flat(tree) -> dict:
    """A JAX gradient pytree as {port parameter name: numpy array}."""
    return {k.replace("/", "."): v
            for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _plain_folded(model, tcfg, x, n):
    """The plain path's (sdf, feat, grad): clamped on the first n rows,
    unclamped after, by torch's double backward."""
    xt = torch.from_numpy(x)
    s, f, g = tf.sdf_feat_grad(model.implicit, tcfg.implicit, xt[:n])
    ge = tf.sdf_gradient(model.implicit, tcfg.implicit, xt[n:])
    raw = tf.implicit_apply(model.implicit, tcfg.implicit, xt[n:])
    return torch.cat([s, raw[:, :1]]), torch.cat([f, raw[:, 1:]]), torch.cat([g, ge])


# -- K3: radiance_norm forward -------------------------------------------------

def _k3_inputs(n=150, seed=5):
    g = _f32(n, 3, seed=seed) * 2.0
    g[:3] = 0.0  # the guarded normalisation at |g| = 0
    return g, _f32(n, 3, seed=seed + 1), _f32(n, 3, seed=seed + 2), _f32(n, 32, seed=seed + 3)


# bf16: pre-activations are rounded to bf16 (values ~1, ulp 2^-7) before the
# bias add and ReLU in both; rgb passes a sigmoid (slope <= 1/4).
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", dict(atol=1e-2))])
def test_k3_plain_matches_pallas(models, dtype, tol):
    jcfg, tcfg, jparams, model = models
    g, pts, vd, feat = _k3_inputs()
    g128 = np.pad(g, ((0, 0), (0, 125)))
    out_j = jit_ref(lambda p, *a: jf.rendering_apply_pallas_wide(p, jcfg.rendering, *a,
                                                                  dtype=JDT[dtype]))(
        jparams["rendering"], *(jnp.asarray(a) for a in (pts, g128, vd, feat)))
    with torch.no_grad():  # K3 is forward-only
        out_t = tf.rendering_apply_pallas_wide(
            model.rendering, tcfg.rendering, *(torch.from_numpy(a) for a in (pts, g, vd, feat)),
            dtype=TDT[dtype])
    _close(out_t["rgb"], out_j["rgb"], **tol)
    _close(out_t["normals"], np.asarray(out_j["normals128"])[:, :3])


def test_k3_plain_matches_jnp_path(models):
    jcfg, tcfg, jparams, model = models
    g, pts, vd, feat = _k3_inputs(seed=9)

    def jnp_path(p, g, pts, vd, feat):
        sq = jnp.sum(g * g, axis=-1, keepdims=True)
        n = g / (jnp.sqrt(jnp.maximum(sq, 1e-24)) + 1e-6)
        return jf.rendering_apply(p, jcfg.rendering, pts, n, vd, feat)["rgb"], n

    rgb_j, n_j = jit_ref(jnp_path)(jparams["rendering"], *(jnp.asarray(a) for a in (g, pts, vd, feat)))
    with torch.no_grad():
        out_t = tf.rendering_apply_pallas_wide(
            model.rendering, tcfg.rendering, *(torch.from_numpy(a) for a in (pts, g, vd, feat)))
    _close(out_t["rgb"], rgb_j)
    _close(out_t["normals"], n_j)


def test_k3_requires_grad_takes_the_autograd_path():
    """A weight or input that requires grad routes K3 through its autograd
    Function (plain versions on the CPU): finite gradients, no launch."""
    gen = torch.Generator().manual_seed(1)
    ws = [(0.3 * torch.randn(11, 8, generator=gen)).requires_grad_(),
          (0.3 * torch.randn(8, 3, generator=gen)).requires_grad_()]
    bs = [torch.zeros(8, requires_grad=True), torch.zeros(3, requires_grad=True)]
    g = torch.randn(5, 3, generator=gen).requires_grad_()
    feat = torch.randn(5, 2, generator=gen).requires_grad_()
    before = dict(build.launches)
    rgb, nrm = radiance_norm(ws, bs, g, torch.randn(5, 6, generator=gen), feat)
    assert type(rgb.grad_fn).__name__ == "_RadianceNormBackward"
    (rgb.sum() + (nrm * torch.arange(3.0)).sum()).backward()
    for t in (*ws, *bs, g, feat):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert build.launches == before


# -- K3b ---------------------------------------------------------------------

def _k3_bwd_case(dtype, seed=21, n=150):
    jcfg, tcfg = configs(True)
    _, model, _ = both_models(jcfg, tcfg)
    tws, tbs = (list(t.detach() for t in ts) for ts in tf.effective_linear_weights(model.rendering))
    g, pts, vd, feat = _k3_inputs(n, seed)
    sv = np.concatenate([pts, np.asarray(positional_encoding(torch.from_numpy(vd), 4))], -1)
    rng = np.random.default_rng(seed)
    co, cn = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    return tws, tbs, g, sv, feat, co, cn


# The same inputs and cotangents into both. float32: sums in another order,
# the kernel parameter-grad bar; bf16: operands and the stored hidden layers
# are bf16 in both; JAX also sums the output layer's bias gradient in bf16
# per block, and a float32 sum in another order can round a hidden
# pre-activation to the neighbouring bf16 value, which flips nothing but
# moves a product by an operand ulp (2^-8 relative).
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 2e-4, 1e-3), ("bfloat16", 1e-2, 2e-2)])
def test_k3_backward_matches_pallas(dtype, atol, rtol):
    tws, tbs, g, sv, feat, co, cn = _k3_bwd_case(dtype)
    ds = sv.shape[1]
    jws, jbs = [jnp.asarray(w.numpy()) for w in tws], [jnp.asarray(b.numpy()) for b in tbs]
    g128 = jnp.asarray(np.pad(g, ((0, 0), (0, 125))))
    dws_j, dbs_j, dg_j, df_j, _ = jit_ref(
        lambda ws, bs, g, sv, feat, co, cn: jrgb._radiance_norm_bwd_pallas(
            ws, bs, g, sv, feat, None, co, cn, ds, JDT[dtype], 64, None))(
        jws, jbs, g128, jnp.asarray(sv), jnp.asarray(feat), jnp.asarray(co),
        jnp.asarray(np.pad(cn, ((0, 0), (0, 125)))))
    dws_t, dbs_t, dg_t, df_t, dc_t = radiance_norm_bwd(
        tws, tbs, *(torch.from_numpy(a) for a in (g, sv, feat, co, cn)), TDT[dtype])
    assert dc_t is None  # no code operand
    assert df_t.dtype == (TDT[dtype] or torch.float32)
    _grad_close(dws_t, dbs_t, dws_j, dbs_j, atol, rtol)
    for a, b in ((dg_t, np.asarray(dg_j)[:, :3]), (df_t, df_j)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(_np(a), b, atol=atol + rtol * float(np.abs(b).max()), rtol=0)


def test_k3_autograd_grads_match_jax_grad_and_double_backward():
    """The autograd Function's gradients (parameters, g, feat) against
    jax.grad through the JAX fused radiance path and against torch's
    autograd of the plain forward, f32 at 2e-4 / 1e-3."""
    jcfg, tcfg = configs(True)
    jparams, model, _ = both_models(jcfg, tcfg)
    g, pts, vd, feat = _k3_inputs(seed=31)
    w = np.random.default_rng(32).normal(size=(g.shape[0], 3)).astype(np.float32)

    def jloss(p, g, feat):
        out = jf.rendering_apply_pallas_wide(p, jcfg.rendering, jnp.asarray(pts),
                                             jnp.pad(g, ((0, 0), (0, 125))), jnp.asarray(vd),
                                             feat)
        return jnp.mean((out["rgb"] - 0.4) ** 2) + jnp.mean(out["normals128"][:, :3] * w)

    gj = jit_ref(jax.grad(jloss, argnums=(0, 1, 2)))(jparams["rendering"], jnp.asarray(g),
                                                      jnp.asarray(feat))

    def tloss(rgb, nrm):
        return ((rgb - 0.4) ** 2).mean() + (nrm * torch.from_numpy(w)).mean()

    gt, ft = torch.from_numpy(g).requires_grad_(), torch.from_numpy(feat).requires_grad_()
    model.zero_grad()
    out = tf.rendering_apply_pallas_wide(model.rendering, tcfg.rendering, torch.from_numpy(pts),
                                         gt, torch.from_numpy(vd), ft)
    tloss(out["rgb"], out["normals"]).backward()
    # the plain forward with torch's own autograd
    gp, fp = torch.from_numpy(g).requires_grad_(), torch.from_numpy(feat).requires_grad_()
    ws, bs = tf.effective_linear_weights(model.rendering)
    sv = torch.cat([torch.from_numpy(pts), positional_encoding(torch.from_numpy(vd), 4)], -1)
    rgb_p, n_p = radiance_norm_plain(ws, bs, gp, sv, fp)
    plain = torch.autograd.grad(tloss(torch.sigmoid(rgb_p), n_p),
                                [gp, fp, *model.rendering.parameters()])
    flat_j = _flat(gj[0])
    assert set(flat_j) == {k for k, _ in model.rendering.named_parameters()}
    pairs = [("g", gt.grad, gj[1], plain[0]), ("feat", ft.grad, gj[2], plain[1])]
    pairs += [(k, p.grad, flat_j[k], q) for (k, p), q in
              zip(model.rendering.named_parameters(), plain[2:])]
    for k, a, b, c in pairs:
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-4, rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(_np(a), _np(c), atol=2e-4, rtol=1e-3, err_msg=k)


# -- K7: sdf_grad_grid (the hash-grid trunk) ---------------------------------------

def _k7_inputs(n=130, d0=71, dims=(32, 32), F=16, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [d0, *dims, F + 1]
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in sizes[1:]]
    inp = rng.normal(size=(n, d0)).astype(np.float32)
    tg = rng.normal(size=(3, n, d0)).astype(np.float32)
    cots = [rng.normal(size=(n, k)).astype(np.float32) for k in (1, F, 3)]
    return ws, bs, inp, tg, cots


@functools.lru_cache(maxsize=None)
def _jax_k7(dtype_name):
    from monosdf_tpu.ops.pallas_sdf_grad_grid import sdf_mlp_with_grad_in as jk7

    def fn(ws, bs, inp, tg, cots):
        out, vjp = jax.vjp(lambda *a: jk7(*a, dtype_name, 64), tuple(ws), tuple(bs), inp, tg)
        return out, vjp(tuple(c.astype(o.dtype) for c, o in zip(cots, out)))

    return jit_ref(fn)


# float32: values at 2e-5, the parameter and input cotangents at 2e-4 / 1e-3
# (sums over 130 points' 4 rows in another order). bf16: operands, Z and
# cotangents rounded at the same points in both, float32 sums in another
# order; a rounding that lands on the neighbouring bf16 value moves a value
# by 2^-8 of its size, and two bf16 ulps (2^-7) of a tensor's largest entry
# bound what that does downstream.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_forward_and_vjp_match_pallas(dtype):
    ws, bs, inp, tg, cots = _k7_inputs()
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    (js_, jf_, jg_), (jdw, jdb, jdinp, jdtg) = _jax_k7("" if tdt is None else dtype)(
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], jnp.asarray(inp),
        jnp.asarray(tg), [jnp.asarray(c) for c in cots])
    t = torch.from_numpy
    a0 = torch.cat([t(inp)[None], t(tg)])
    tws, tbs = [t(w) for w in ws], [t(b) for b in bs]
    sdf, feat, grad, zs = sdf_mlp_with_grad_in_plain(tws, tbs, a0, tdt, save_z=True)
    dws, dbs, da0 = sdf_mlp_with_grad_in_bwd_plain(tws, tbs, a0, zs, *map(t, cots), tdt)

    def close(a, b, atol, rtol):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        if tdt is None:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2**-7 * np.abs(b).max())

    for a, b in ((sdf, js_), (feat, jf_), (grad, jg_)):
        close(a, b, **TOL)
    for a, b in (*zip(dws, jdw), *zip(dbs, jdb), (da0[0], jdinp), (da0[1:], jdtg)):
        close(a, b, 2e-4, 1e-3)
    # the autograd Function (K7f with saved Z, K7b) gives the same cotangents
    a0g = a0.clone().requires_grad_(True)
    wg = [w.clone().requires_grad_(True) for w in tws]
    out = sdf_mlp_with_grad_in(wg, tbs, a0g, tdt)
    torch.autograd.backward(out, [t(c).to(o.dtype) for c, o in zip(cots, out)])
    assert torch.allclose(a0g.grad, da0, rtol=1e-6, atol=1e-6)
    assert all(torch.allclose(w.grad, d, rtol=1e-6, atol=1e-6) for w, d in zip(wg, dws))

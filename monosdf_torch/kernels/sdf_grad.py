"""K2: SDF, features and spatial gradient of the SDF MLP, and its backward.

K2f replaces ``monosdf_tpu/ops/pallas_sdf_grad.py _fwd_pallas`` (its
``pl.pallas_call`` at :414), K2b its ``_bwd_pallas`` (``pl.pallas_call`` at
:713); ``sdf_mlp_with_grad`` is the counterpart of that file's custom_vjp
function, reached from ``fields.sdf_feat_grad_pallas``. Kernels:
``csrc/sdf_grad.cu`` (forward) and ``csrc/sdf_grad_bwd.cu`` (backward).

The forward takes raw points, computes the positional embedding and its
three basis tangents in-kernel, and runs the primal rows and the tangent
rows through the MLP together (tangent = sigmoid(100 z) * u between layers,
no bias on the tangents). The bounding-sphere clamp of SDF and gradient runs
in-kernel; rows at or after ``clamp_rows`` (the folded eikonal batch) skip
it. For training (``save_z``) it also returns the take-MLP ``flag`` (1.0
where the MLP won the clamp, and on unclamped rows) and every hidden layer's
pre-activation Z at the operand dtype, laid out ``zs[l]`` = (4, N, out_l):
``zs[l][0]`` the primal rows (bias added), ``zs[l][1 + k]`` the tangent rows
along axis k (no bias).

The backward is the hand-written second-order VJP: it reverses the primal
chain and the three tangent chains together and returns the parameter
gradients only (the points' cotangent is zero: sample points are data in
every loss). Per layer, from the stored Z:

    ct_z   = ct_h * s + (sum_k ct_t_k * u_k) * 100 s (1 - s)
    ct_u_k = s * ct_t_k
    dW    += A^T CT,   db += sum of CT's primal rows,   ct_A = CT W^T

with s = sigmoid(100 z), the cotangents cast to the operand dtype at entry,
the SDF and gradient cotangents gated by ``flag``, and bf16 operands with
float32 sums under mixed precision.

Bound on the card: operations (forward about 4.4e11 FLOP, backward about
twice that, at the bench's 104,448 training points, against ~1.7 GB of bf16
Z written and read back). The forward and the float32 backward compute with
float32 FMAs on the CUDA cores. The bf16 backward runs on the tensor cores
in two passes (``_bwd_tc``, csrc/sdf_grad_bwd.cu): the tile loop stores each
layer's bf16 CT and input A, 64 rows a block in ``wgmma``'s operand layout
(~3.7 GB of scratch at the bench's shapes), and a second kernel sums
``A^T CT`` over all rows, so no dW partial goes through device memory per
tile; partials are summed in a fixed order (two runs, the same bits).
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import matmul_rounded, round_to
from . import build
from .sdf_mlp import SQRT2, WG_N, check_mlp_dims, pack_wgmma_b

NAME = "sdf_grad"
BWD_NAME = "sdf_grad_bwd"
_c = ctypes.c_void_p


def gate100(z: torch.Tensor):
    """(softplus_100(z), sigmoid(100 z)) from one exponential."""
    e = torch.exp(100.0 * torch.clamp(z, max=0.2))
    hot = z > 0.2
    s = torch.where(hot, torch.ones_like(z), e / (1.0 + e))
    h = torch.where(hot, z, torch.log1p(e) / 100.0)
    return h, s


def pe_with_tangents(x: torch.Tensor, multires: int):
    """Embedding (N, d0) = [x, sin(2^f x), cos(2^f x), ...] and its tangents
    along the three axes, stacked (3N, d0)."""
    N = x.shape[0]
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[:, None, :] * freqs[:, None]  # (N, F, 3)
    s, c = torch.sin(xb), torch.cos(xb)
    emb = torch.cat([x, torch.cat([s, c], dim=-1).reshape(N, -1)], dim=-1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    fr = freqs[None, :, None]
    tsin = (fr * c)[None] * eye[:, None, None, :]  # (3, N, F, 3)
    tcos = (-fr * s)[None] * eye[:, None, None, :]
    tang = torch.cat(
        [eye[:, None, :].expand(3, N, 3), torch.cat([tsin, tcos], dim=-1).reshape(3, N, -1)],
        dim=-1,
    )
    return emb, tang.reshape(3 * N, -1)


def clamp_to_sphere(sdf, grad, x, bounding_sphere: float, sphere_scale: float,
                    clamp_rows: int = -1):
    """min(sdf, s*(R - |x|)) and the matching gradient select; rows at or
    after ``clamp_rows`` (when >= 0) keep the MLP's values. Returns (sdf,
    grad, take) with take (N, 1) bool: the MLP's value was kept."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    sphere = sphere_scale * (bounding_sphere - norm)
    take = sdf <= sphere
    if clamp_rows >= 0:
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        take = take | (rows >= clamp_rows)
    grad_sphere = x * (-sphere_scale / torch.clamp(norm, min=1e-12))
    return torch.where(take, sdf, sphere), torch.where(take, grad, grad_sphere), take


def sdf_mlp_with_grad_plain(ws, bs, x, multires: int, skip_in, dtype=None,
                            bounding_sphere: float = 0.0, sphere_scale: float = 1.0,
                            clamp_rows: int = -1, save_z: bool = False):
    """K2f's function in plain PyTorch, with its rounding points: (sdf,
    feat, grad), and with ``save_z`` also (flag, zs) as the module
    docstring lays them out (flag None without the clamp)."""
    N = x.shape[0]
    emb, tang = pe_with_tangents(x.float(), multires)
    A0 = torch.cat([emb, tang], dim=0)  # (4N, d0)
    A = A0
    L = len(ws)
    zs = []
    for l in range(L - 1):
        if l in skip_in:
            A = torch.cat([A, A0], dim=-1) / SQRT2
        Z = matmul_rounded(A, ws[l], dtype)
        zp = Z[:N] + bs[l]
        if save_z:
            zs.append(torch.cat([zp, Z[N:]], dim=0).to(dtype or torch.float32).reshape(4, N, -1))
        h, s = gate100(zp)
        A = round_to(torch.cat([h, s.repeat(3, 1) * Z[N:]], dim=0), dtype)
    if (L - 1) in skip_in:
        A = torch.cat([A, A0], dim=-1) / SQRT2
    Zp = matmul_rounded(A[:N], ws[-1], dtype) + bs[-1]
    Zt = matmul_rounded(A[N:], ws[-1][:, :1], dtype)
    sdf, feat = Zp[:, :1], Zp[:, 1:]
    grad = Zt.reshape(3, N).T
    flag = None
    if bounding_sphere > 0.0:
        sdf, grad, take = clamp_to_sphere(sdf, grad, x.float(), bounding_sphere, sphere_scale,
                                          clamp_rows)
        flag = take.float()
    out = sdf, (feat.to(dtype) if dtype is not None else feat), grad.contiguous()
    return (*out, flag, zs) if save_z else out


def sdf_mlp_with_grad_bwd_plain(ws, bs, x, zs, c_sdf, c_feat, c_grad, multires: int, skip_in,
                                dtype=None, flag=None):
    """K2b's function in plain PyTorch, with its rounding points: the
    parameter gradients (dws, dbs) of the outputs' cotangents c_sdf (N, 1),
    c_feat (N, F), c_grad (N, 3). zs: the forward's saved Z, or None to
    recompute them; flag: the forward's take-MLP flag, or None."""
    N = x.shape[0]
    L = len(ws)
    if zs is None:
        zs = sdf_mlp_with_grad_plain(ws, bs, x, multires, skip_in, dtype, save_z=True)[4]
    emb, tang = pe_with_tangents(x.float(), multires)
    A0 = torch.cat([emb, tang], dim=0)
    cs, cf, cg = (round_to(c, dtype) for c in (c_sdf, c_feat, c_grad))
    if flag is not None:
        cs, cg = cs * flag, cg * flag

    def a_in(l):
        """The layer-l matmul input, from the stored Z of layer l - 1."""
        if l == 0:
            return A0
        Z = zs[l - 1].float()
        h, s = gate100(Z[0])
        a = torch.cat([h[None], s[None] * Z[1:]]).reshape(4 * N, -1)
        return torch.cat([a, A0], dim=-1) / SQRT2 if l in skip_in else a

    dws, dbs = [None] * L, [None] * L
    # last layer: primal rows carry [c_sdf | c_feat], tangent rows c_grad in
    # the SDF column only
    CT = torch.zeros(4 * N, ws[-1].shape[1], dtype=torch.float32, device=x.device)
    CT[:N] = torch.cat([cs, cf], dim=-1)
    CT[N:, 0] = cg.T.reshape(-1)
    dws[-1] = matmul_rounded(a_in(L - 1).T, CT, dtype)
    dbs[-1] = CT[:N].sum(0)

    def to_prev(CT, l):
        """The cotangent of layer l - 1's output: CT W_l^T without the
        embedding's columns, the skip scaling undone."""
        ct = matmul_rounded(CT, ws[l].T, dtype)[:, :ws[l - 1].shape[1]]
        return ct / SQRT2 if l in skip_in else ct

    ct = to_prev(CT, L - 1)
    for l in range(L - 2, -1, -1):
        Z = zs[l].float()
        _, s = gate100(Z[0])
        s2 = 100.0 * s * (1.0 - s)
        ct4 = ct.reshape(4, N, -1)
        ct_sum = ct4[1] * Z[1] + ct4[2] * Z[2] + ct4[3] * Z[3]
        ct_z = ct4[0] * s + ct_sum * s2
        CT = torch.cat([ct_z[None], s[None] * ct4[1:]]).reshape(4 * N, -1)
        dws[l] = matmul_rounded(a_in(l).T, CT, dtype)
        dbs[l] = ct_z.sum(0)
        if l > 0:
            ct = to_prev(CT, l)
    return dws, dbs


# -- the kernels -------------------------------------------------------------


def _lib():
    lib = build.load(NAME)
    lib.sdf_grad_launch.restype = ctypes.c_int
    lib.sdf_grad_launch.argtypes = [
        _c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), _c, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, _c, _c, _c, _c, ctypes.POINTER(_c), ctypes.c_int, _c,
    ]
    return lib


def _bwd_lib():
    lib = build.load(BWD_NAME)
    lib.sdf_grad_bwd_launch.restype = ctypes.c_int
    lib.sdf_grad_bwd_launch.argtypes = [
        _c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), _c, _c, ctypes.POINTER(_c),
        _c, _c, _c, _c, _c, ctypes.c_int, ctypes.c_int, _c, _c,
    ]
    _i, _pi, _pc = ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_c)
    lib.sdf_grad_bwd_tc_launch.restype = ctypes.c_int
    lib.sdf_grad_bwd_tc_launch.argtypes = [
        _c, _i, _i, _pi, _c, _pi, _pc, _pc, _pc, _pi, _c, _c, _c, _c, _c, _i, _i, _c, _i, _i, _c, _c,
    ]
    return lib


def _z_ptrs(zs):
    arr = (_c * build.MAX_LAYERS)()
    for l, z in enumerate(zs):
        arr[l] = z.data_ptr()
    return arr


def _ints(vals):
    return (ctypes.c_int * build.MAX_LAYERS)(*vals, *[0] * (build.MAX_LAYERS - len(vals)))


BWD_KC = 32     # csrc/sdf_grad_bwd.cu TB_KC: W rows per pass-1 ring stage
BWD_SMALL = 2816  # csrc/sdf_grad_bwd.cu MAX_SMALL
TILE_ROWS = 64  # rows of a 16-point tile: the primal rows, then the three tangents'


def _bwd_tc(ws, x, zs, cs, cf, cg, flag, multires, desc, out):
    """K2b's bf16 path (csrc/sdf_grad_bwd.cu): pass 1 stores every layer's
    CT and input A in wgmma's layout, 64 rows a block; pass 2 sums A^T CT
    over the blocks on the tensor cores; partials are summed in order."""
    dev = x.device
    N, L = x.shape[0], len(ws)
    if any(w.shape[0] > 256 for w in ws):
        raise ValueError("the tensor-core backward takes layer inputs up to 256 wide")
    n_small = sum(w.shape[1] for w in ws) + ws[-1].shape[0]
    if n_small > BWD_SMALL:
        raise ValueError(f"{n_small} bias and SDF-column gradients > {BWD_SMALL}")
    # pass 1's B operands: W_l[:nprev]^T (its K: layer l's outputs)
    wb, offs = pack_wgmma_b([ws[l][:ws[l - 1].shape[1]].t() for l in range(1, L)], BWD_KC)
    n_tiles = -(-N // 16)
    kap = [-(-w.shape[0] // 128) * 128 for w in ws]
    blk = n_tiles * TILE_ROWS
    scratch = torch.empty(blk * (WG_N * L + sum(kap)), dtype=torch.bfloat16, device=dev)
    ct_ptrs, a_ptrs = (_c * build.MAX_LAYERS)(), (_c * build.MAX_LAYERS)()
    off = 0
    for l in range(L):
        ct_ptrs[l] = scratch[off:].data_ptr()
        off += blk * WG_N
    for l in range(L):
        a_ptrs[l] = scratch[off:].data_ptr()
        off += blk * kap[l]
    sms = build.num_sms(dev)
    grid1 = min(sms, n_tiles)
    blocks = sum(k // 128 for k in kap)
    splits = max(1, min(n_tiles, sms // blocks))
    part1 = torch.empty(grid1, n_small, dtype=torch.float32, device=dev)
    part2 = torch.empty(blocks * splits, 128, WG_N, dtype=torch.float32, device=dev)
    n_w = sum(w.shape[0] * w.shape[1] for w in ws) - ws[-1].shape[0]
    lib = _bwd_lib()
    err = lib.sdf_grad_bwd_tc_launch(
        build.ptr(x), N, multires, desc, build.ptr(wb), _ints([0] + offs), _z_ptrs(zs), ct_ptrs,
        a_ptrs, _ints(kap), build.ptr(cs), build.ptr(cf), build.ptr(cg),
        build.ptr(flag) if flag is not None else None, build.ptr(part1), grid1, n_small,
        build.ptr(part2), splits, max(n_small, n_w), build.ptr(out), build.stream_ptr(dev),
    )
    build.check(lib, BWD_NAME, err)


def _forward(ws, bs, x, multires, skip_in, dtype, bounding_sphere, sphere_scale, clamp_rows,
             save_z):
    """K2f on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return sdf_mlp_with_grad_plain(ws, bs, x, multires, skip_in, dtype, bounding_sphere,
                                       sphere_scale, clamp_rows, save_z)
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    dev = x.device
    N = x.shape[0]
    build.require(x, "x", torch.float32, (N, 3), dev)
    d0 = 3 * (1 + 2 * multires)
    F = ws[-1].shape[1] - 1
    check_mlp_dims(ws, tuple(skip_in), d0, last_max=257)
    P, desc = build.pack_mlp(ws, bs, tuple(skip_in))
    build.require(P, "weights", torch.float32, P.shape, dev)
    act = dtype or torch.float32
    sdf = torch.empty(N, 1, dtype=torch.float32, device=dev)
    feat = torch.empty(N, F, dtype=act, device=dev)
    grad = torch.empty(N, 3, dtype=torch.float32, device=dev)
    clamp = bounding_sphere > 0.0
    flag = torch.empty(N, 1, dtype=torch.float32, device=dev) if save_z and clamp else None
    zs = [torch.empty(4, N, w.shape[1], dtype=act, device=dev) for w in ws[:-1]] if save_z else []
    if N > 0:
        lib = _lib()
        err = lib.sdf_grad_launch(
            build.ptr(x), N, multires, desc, build.ptr(P), float(bounding_sphere),
            float(sphere_scale), int(clamp_rows), build.ptr(sdf), build.ptr(feat),
            build.ptr(grad), build.ptr(flag) if flag is not None else None, _z_ptrs(zs),
            int(dtype is not None), build.stream_ptr(dev),
        )
        build.check(lib, NAME, err)
        build.launches[NAME] += 1
    return (sdf, feat, grad, flag, zs) if save_z else (sdf, feat, grad)


def sdf_mlp_with_grad_bwd(ws, bs, x, zs, c_sdf, c_feat, c_grad, multires: int, skip_in,
                          dtype=None, flag=None):
    """K2b: (dws, dbs) float32 at the weights' shapes. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, which reads the
    saved Z (``zs`` from the forward with ``save_z``; it does not recompute
    them)."""
    if x.device.type == "cpu":
        return sdf_mlp_with_grad_bwd_plain(ws, bs, x, zs, c_sdf, c_feat, c_grad, multires,
                                           skip_in, dtype, flag)
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    if zs is None:
        raise ValueError("the backward kernel reads the forward's saved Z (save_z=True)")
    dev = x.device
    N = x.shape[0]
    act = dtype or torch.float32
    L = len(ws)
    F = ws[-1].shape[1] - 1
    build.require(x, "x", torch.float32, (N, 3), dev)
    d0 = 3 * (1 + 2 * multires)
    check_mlp_dims(ws, tuple(skip_in), d0, last_max=257)
    if L < 2:
        raise ValueError("the backward kernel takes an MLP with hidden layers")
    if len(zs) != L - 1:
        raise ValueError(f"{len(zs)} saved Z, expected {L - 1}")
    for l, z in enumerate(zs):
        build.require(z, f"zs[{l}]", act, (4, N, ws[l].shape[1]), dev)
    cs = c_sdf.to(act).contiguous()
    cf = c_feat.to(act).contiguous()
    cg = c_grad.to(act).contiguous()
    build.require(cs, "c_sdf", act, (N, 1), dev)
    build.require(cf, "c_feat", act, (N, F), dev)
    build.require(cg, "c_grad", act, (N, 3), dev)
    if flag is not None:
        build.require(flag, "flag", torch.float32, (N, 1), dev)
    P, desc = build.pack_mlp(ws, bs, tuple(skip_in))
    build.require(P, "weights", torch.float32, P.shape, dev)
    n_params = P.numel()
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    if N > 0 and dtype is not None:
        _bwd_tc(ws, x, zs, cs, cf, cg, flag, multires, desc, out)
        build.launches[BWD_NAME] += 1
    elif N > 0:
        # W^T of every layer at the same offsets, for ct_A = CT W^T
        PT, _ = build.pack_mlp([w.t() for w in ws], bs)
        grid = min(build.num_sms(dev), -(-N // 16))  # csrc/sdf_grad_bwd.cu PTS points a tile
        work = torch.empty(grid, n_params, dtype=torch.float32, device=dev)
        lib = _bwd_lib()
        err = lib.sdf_grad_bwd_launch(
            build.ptr(x), N, multires, desc, build.ptr(P), build.ptr(PT), _z_ptrs(zs),
            build.ptr(cs), build.ptr(cf), build.ptr(cg),
            build.ptr(flag) if flag is not None else None, build.ptr(work), grid, n_params,
            build.ptr(out), build.stream_ptr(dev),
        )
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    else:
        out.zero_()
    return build.unpack_mlp(out, ws, bs)


class _SdfMlpWithGrad(torch.autograd.Function):
    """K2f with ``save_z`` forward, K2b backward, over the effective weights
    and biases (weight norm stays outside, so autograd chains
    d(effective W)/d(g, v))."""

    @staticmethod
    def forward(ctx, x, meta, *wb):
        multires, skip_in, dtype, bounding_sphere, sphere_scale, clamp_rows = meta
        L = len(wb) // 2
        ws, bs = list(wb[:L]), list(wb[L:])
        sdf, feat, grad, flag, zs = _forward(ws, bs, x, multires, skip_in, dtype,
                                             bounding_sphere, sphere_scale, clamp_rows, True)
        ctx.meta, ctx.L, ctx.has_flag = meta, L, flag is not None
        ctx.save_for_backward(x, *wb, *zs, *([flag] if flag is not None else []))
        return sdf, feat, grad

    @staticmethod
    def backward(ctx, c_sdf, c_feat, c_grad):
        multires, skip_in, dtype = ctx.meta[:3]
        L = ctx.L
        saved = ctx.saved_tensors
        x, ws, bs = saved[0], list(saved[1:1 + L]), list(saved[1 + L:1 + 2 * L])
        zs = list(saved[1 + 2 * L:1 + 2 * L + L - 1])
        flag = saved[-1] if ctx.has_flag else None
        dws, dbs = sdf_mlp_with_grad_bwd(ws, bs, x, zs, c_sdf, c_feat, c_grad, multires,
                                         skip_in, dtype, flag)
        return (None, None, *dws, *dbs)


def sdf_mlp_with_grad(ws, bs, x, multires: int, skip_in, dtype=None,
                      bounding_sphere: float = 0.0, sphere_scale: float = 1.0,
                      clamp_rows: int = -1, save_z: bool = False):
    """(sdf (N, 1) float32, feat (N, F) at the operand dtype, grad (N, 3)
    float32) of the SDF MLP over raw points x (N, 3); with ``save_z`` also
    (flag, zs) as the module docstring lays them out.

    ws/bs: effective weights, natural column order (sdf first). When a
    weight requires grad (and grad is enabled), the call goes through the
    autograd Function: K2f with saved Z forward, K2b backward. A CPU tensor
    takes the plain versions; a CUDA tensor launches the kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*ws, *bs)):
        if save_z:
            raise ValueError("save_z returns the kernel's residuals; it is a no-grad call")
        meta = (multires, tuple(skip_in), dtype, float(bounding_sphere), float(sphere_scale),
                int(clamp_rows))
        return _SdfMlpWithGrad.apply(x.detach(), meta, *ws, *bs)
    return _forward(ws, bs, x, multires, tuple(skip_in), dtype, bounding_sphere, sphere_scale,
                    clamp_rows, save_z)

"""K7: the hash-grid trunk's SDF, features and spatial gradient over a given
layer-0 input, and its backward with the input cotangents.

K7f replaces ``monosdf_tpu/ops/pallas_sdf_grad_grid.py _fwd_pallas_a0``
(its ``pl.pallas_call`` at :165), K7b its ``_bwd_pallas_a0``
(``pl.pallas_call`` at :351); ``sdf_mlp_with_grad_in`` is the counterpart
of that file's custom_vjp function, reached from
``fields.sdf_feat_grad_pallas_grid``. Kernels: ``csrc/sdf_grad_grid.cu``
and ``csrc/sdf_grad_grid_bwd.cu``.

The layer-0 input comes assembled: a0 (4, N, d0) float32, ``a0[0]`` the
rows [PE(x) | grid features] and ``a0[1 + k]`` their derivatives along axis
k. The primal and tangent rows run through the trunk together, as in K2
(tangent = sigmoid(100 z) * u between layers, no bias on the tangents), with
no skip and no clamp. Saved Z are laid out as K2's: ``zs[l]`` (4, N, out_l)
at the operand dtype. The backward returns the parameter gradients and
da0 (4, N, d0) float32, the cotangent of a0, which the autograd Function
hands back to the encode (K5 takes its grid-feature columns).

Bound on the card: operations (forward about 8.4e10 FLOP at the bench's
104,448 training points, backward about twice that). These first versions
compute with float32 FMAs on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import matmul_rounded, round_to
from . import build
from .sdf_grad import _z_ptrs, gate100
from .sdf_mlp import check_mlp_dims

NAME = "sdf_grad_grid"
BWD_NAME = "sdf_grad_grid_bwd"
_c = ctypes.c_void_p


def sdf_mlp_with_grad_in_plain(ws, bs, a0, dtype=None, save_z: bool = False):
    """K7f's function in plain PyTorch, with its rounding points: (sdf (N,
    1) float32, feat (N, F) at the operand dtype, grad (N, 3) float32), and
    with ``save_z`` also zs."""
    N = a0.shape[1]
    A = a0.reshape(4 * N, -1).float()
    zs = []
    for l in range(len(ws) - 1):
        Z = matmul_rounded(A, ws[l], dtype)
        zp = Z[:N] + bs[l]
        if save_z:
            zs.append(torch.cat([zp, Z[N:]], dim=0).to(dtype or torch.float32).reshape(4, N, -1))
        h, s = gate100(zp)
        A = round_to(torch.cat([h, s.repeat(3, 1) * Z[N:]], dim=0), dtype)
    Zp = matmul_rounded(A[:N], ws[-1], dtype) + bs[-1]
    Zt = matmul_rounded(A[N:], ws[-1][:, :1], dtype)
    feat = Zp[:, 1:]
    out = Zp[:, :1], (feat.to(dtype) if dtype is not None else feat), Zt.reshape(3, N).T.contiguous()
    return (*out, zs) if save_z else out


def sdf_mlp_with_grad_in_bwd_plain(ws, bs, a0, zs, c_sdf, c_feat, c_grad, dtype=None):
    """K7b's function in plain PyTorch, with its rounding points: (dws, dbs,
    da0) for the outputs' cotangents c_sdf (N, 1), c_feat (N, F), c_grad
    (N, 3). zs: the forward's saved Z, or None to recompute them."""
    N = a0.shape[1]
    L = len(ws)
    if zs is None:
        zs = sdf_mlp_with_grad_in_plain(ws, bs, a0, dtype, save_z=True)[3]
    A0 = a0.reshape(4 * N, -1).float()
    cs, cf, cg = (round_to(c, dtype) for c in (c_sdf, c_feat, c_grad))

    def a_in(l):
        if l == 0:
            return A0
        Z = zs[l - 1].float()
        h, s = gate100(Z[0])
        return torch.cat([h[None], s[None] * Z[1:]]).reshape(4 * N, -1)

    dws, dbs = [None] * L, [None] * L
    CT = torch.zeros(4 * N, ws[-1].shape[1], dtype=torch.float32, device=a0.device)
    CT[:N] = torch.cat([cs, cf], dim=-1)
    CT[N:, 0] = cg.T.reshape(-1)
    dws[-1] = matmul_rounded(a_in(L - 1).T, CT, dtype)
    dbs[-1] = CT[:N].sum(0)
    ct = matmul_rounded(CT, ws[-1].T, dtype)
    for l in range(L - 2, -1, -1):
        Z = zs[l].float()
        _, s = gate100(Z[0])
        s2 = 100.0 * s * (1.0 - s)
        ct4 = ct.reshape(4, N, -1)
        ct_z = ct4[0] * s + (ct4[1] * Z[1] + ct4[2] * Z[2] + ct4[3] * Z[3]) * s2
        CT = torch.cat([ct_z[None], s[None] * ct4[1:]]).reshape(4 * N, -1)
        dws[l] = matmul_rounded(a_in(l).T, CT, dtype)
        dbs[l] = ct_z.sum(0)
        ct = matmul_rounded(CT, ws[l].T, dtype)
    return dws, dbs, ct.reshape(4, N, -1)


# -- the kernels -------------------------------------------------------------


def _check(ws, a0, dtype):
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    if len(ws) < 2:
        raise ValueError("the kernels take a trunk with hidden layers")
    build.require(a0, "a0", torch.float32, (4, a0.shape[1], a0.shape[2]), a0.device)
    check_mlp_dims(ws, (), a0.shape[2], last_max=257)


def _forward(ws, bs, a0, dtype, save_z):
    """K7f on a CUDA tensor, its plain version on a CPU tensor."""
    if a0.device.type == "cpu":
        return sdf_mlp_with_grad_in_plain(ws, bs, a0, dtype, save_z)
    _check(ws, a0, dtype)
    dev, N, d0 = a0.device, a0.shape[1], a0.shape[2]
    P, desc = build.pack_mlp(ws, bs)
    build.require(P, "weights", torch.float32, P.shape, dev)
    act = dtype or torch.float32
    sdf = torch.empty(N, 1, dtype=torch.float32, device=dev)
    feat = torch.empty(N, ws[-1].shape[1] - 1, dtype=act, device=dev)
    grad = torch.empty(N, 3, dtype=torch.float32, device=dev)
    zs = [torch.empty(4, N, w.shape[1], dtype=act, device=dev) for w in ws[:-1]] if save_z else []
    if N > 0:
        lib = build.load(NAME)
        lib.sdf_grad_grid_launch.restype = ctypes.c_int
        lib.sdf_grad_grid_launch.argtypes = [_c, ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int), _c, _c, _c, _c,
                                             ctypes.POINTER(_c), ctypes.c_int, _c]
        err = lib.sdf_grad_grid_launch(build.ptr(a0), N, d0, desc, build.ptr(P), build.ptr(sdf),
                                       build.ptr(feat), build.ptr(grad), _z_ptrs(zs),
                                       int(dtype is not None), build.stream_ptr(dev))
        build.check(lib, NAME, err)
        build.launches[NAME] += 1
    return (sdf, feat, grad, zs) if save_z else (sdf, feat, grad)


def sdf_mlp_with_grad_in_bwd(ws, bs, a0, zs, c_sdf, c_feat, c_grad, dtype=None):
    """K7b: (dws, dbs) float32 at the weights' shapes and da0 (4, N, d0)
    float32. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel, which reads the forward's saved Z."""
    if a0.device.type == "cpu":
        return sdf_mlp_with_grad_in_bwd_plain(ws, bs, a0, zs, c_sdf, c_feat, c_grad, dtype)
    _check(ws, a0, dtype)
    if zs is None:
        raise ValueError("the backward kernel reads the forward's saved Z (save_z=True)")
    dev, N, d0 = a0.device, a0.shape[1], a0.shape[2]
    act = dtype or torch.float32
    F = ws[-1].shape[1] - 1
    if len(zs) != len(ws) - 1:
        raise ValueError(f"{len(zs)} saved Z, expected {len(ws) - 1}")
    for l, z in enumerate(zs):
        build.require(z, f"zs[{l}]", act, (4, N, ws[l].shape[1]), dev)
    cs, cf, cg = (c.to(act).contiguous() for c in (c_sdf, c_feat, c_grad))
    build.require(cs, "c_sdf", act, (N, 1), dev)
    build.require(cf, "c_feat", act, (N, F), dev)
    build.require(cg, "c_grad", act, (N, 3), dev)
    P, desc = build.pack_mlp(ws, bs)
    PT, _ = build.pack_mlp([w.t() for w in ws], bs)  # W^T at the same offsets
    n_params = P.numel()
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    da0 = torch.empty(4, N, d0, dtype=torch.float32, device=dev)
    if N > 0:
        grid = min(build.num_sms(dev), -(-N // 16))  # csrc/common.cuh PTS points a tile
        work = torch.empty(grid, n_params, dtype=torch.float32, device=dev)
        lib = build.load(BWD_NAME)
        lib.sdf_grad_grid_bwd_launch.restype = ctypes.c_int
        lib.sdf_grad_grid_bwd_launch.argtypes = [
            _c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), _c, _c,
            ctypes.POINTER(_c), _c, _c, _c, _c, ctypes.c_int, ctypes.c_int, _c, _c, ctypes.c_int,
            _c,
        ]
        err = lib.sdf_grad_grid_bwd_launch(
            build.ptr(a0), N, d0, desc, build.ptr(P), build.ptr(PT), _z_ptrs(zs), build.ptr(cs),
            build.ptr(cf), build.ptr(cg), build.ptr(work), grid, n_params, build.ptr(out),
            build.ptr(da0), int(dtype is not None), build.stream_ptr(dev),
        )
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    else:
        out.zero_()
    dws, dbs = build.unpack_mlp(out, ws, bs)
    return dws, dbs, da0


class _SdfMlpWithGradIn(torch.autograd.Function):
    """K7f with saved Z forward, K7b backward, over the layer-0 input a0 and
    the effective weights and biases."""

    @staticmethod
    def forward(ctx, a0, dtype, *wb):
        L = len(wb) // 2
        sdf, feat, grad, zs = _forward(list(wb[:L]), list(wb[L:]), a0, dtype, True)
        ctx.dtype, ctx.L = dtype, L
        ctx.save_for_backward(a0, *wb, *zs)
        return sdf, feat, grad

    @staticmethod
    def backward(ctx, c_sdf, c_feat, c_grad):
        L = ctx.L
        saved = ctx.saved_tensors
        a0, ws, bs, zs = saved[0], list(saved[1:1 + L]), list(saved[1 + L:1 + 2 * L]), list(
            saved[1 + 2 * L:])
        dws, dbs, da0 = sdf_mlp_with_grad_in_bwd(ws, bs, a0, zs, c_sdf, c_feat, c_grad, ctx.dtype)
        return (da0, None, *dws, *dbs)


def sdf_mlp_with_grad_in(ws, bs, a0, dtype=None):
    """(sdf (N, 1) float32, feat (N, F) at the operand dtype, grad (N, 3)
    float32) of the trunk over a0 (4, N, d0) float32, the layer-0 input and
    its three tangents. ws/bs: effective weights, natural column order (sdf
    first). Under grad (a weight or a0 requiring it) the call goes through
    the autograd Function: K7f with saved Z forward, K7b backward, which
    returns a0's cotangent too. A CPU tensor takes the plain versions; a
    CUDA tensor launches the kernels."""
    a0 = a0.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a0, *ws, *bs)):
        return _SdfMlpWithGradIn.apply(a0, dtype, *ws, *bs)
    return _forward(ws, bs, a0, dtype, False)

"""K3: radiance trunk with in-kernel normal normalisation, and its backward.

K3f replaces ``monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_fwd_pallas``
(its ``pl.pallas_call`` at :708), K3b its ``_radiance_norm_bwd_pallas``
(``pl.pallas_call`` at :889); ``radiance_norm`` is the counterpart of that
file's custom_vjp function, reached from
``fields.rendering_apply_pallas_wide``. Kernels: ``csrc/radiance_norm.cu``
and ``csrc/radiance_norm_bwd.cu``.

n = g / (sqrt(max(|g|^2, 1e-24)) + 1e-6), then the ReLU trunk over
``[points, view PE, n, features]`` (W0's natural row order); returns the
pre-sigmoid rgb and n. With bf16 each hidden pre-activation is rounded to
bf16 before its bias add and ReLU, as in the TPU kernel.

The backward recomputes the trunk, runs the ReLU reverse sweep, takes the
layer-0 weight gradient from the normalised n, writes the feature cotangent
at the operand dtype, and runs the normalise backward with both normal
cotangents summed (the ``normals`` output's and the one through the
radiance input): dg = dn/q - g (<dn, g> / (q^2 r)) [|g|^2 > 1e-24], r =
sqrt(max(|g|^2, 1e-24)), q = r + 1e-6. The points and view PE get no
cotangent. dW0 comes back in W0's natural row order.

Bound on the card: operations, narrowly (forward about 2.8e10 FLOP per
100,352-sample batch, backward about three times that, against ~55 MB of
bf16 features and outputs, ~16 us at 3.35 TB/s). Both keep the 289-wide
input row and the hidden layers in shared memory, so device memory sees
each input once and each output once; they compute with float32 FMAs on
the CUDA cores. No per-image code operand yet.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import matmul_rounded, round_to
from . import build

NAME = "radiance_norm"
BWD_NAME = "radiance_norm_bwd"
_c = ctypes.c_void_p


def normalize(g: torch.Tensor) -> torch.Tensor:
    """Guarded normalisation g / (sqrt(max(|g|^2, 1e-24)) + 1e-6)."""
    sq = torch.sum(g * g, dim=-1, keepdim=True)
    return g / (torch.sqrt(torch.clamp(sq, min=1e-24)) + 1e-6)


def _trunk_hidden(ws, bs, h, dtype):
    """The inputs of every layer: [h0, relu(y_0), ..., relu(y_{L-2})]."""
    acts = [h]
    for l in range(len(ws) - 1):
        acc = matmul_rounded(h, ws[l], dtype)
        y = (acc.to(dtype) + bs[l].to(dtype)).float() if dtype is not None else acc + bs[l]
        h = torch.relu(y)
        acts.append(h)
    return acts


def radiance_norm_plain(ws, bs, g, sv, feat, dtype=None):
    """K3f's function in plain PyTorch: (rgb_pre (N, 3), normals (N, 3))."""
    n = normalize(g.float())
    h = _trunk_hidden(ws, bs, torch.cat([sv.float(), n, feat.float()], dim=-1), dtype)[-1]
    return matmul_rounded(h, ws[-1], dtype) + bs[-1], n


def radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, dtype=None):
    """K3b's function in plain PyTorch, with its rounding points: (dws,
    dbs, dg (N, 3) float32, df (N, F) at the operand dtype) for the
    cotangents co (N, 3) of rgb_pre and cn (N, 3) of the normals."""
    g = g.float()
    sq = torch.sum(g * g, dim=-1, keepdim=True)
    r = torch.sqrt(torch.clamp(sq, min=1e-24))
    q = r + 1e-6
    ds = sv.shape[1]
    acts = _trunk_hidden(ws, bs, torch.cat([sv.float(), g / q, feat.float()], dim=-1), dtype)
    L = len(ws)
    dws, dbs = [None] * L, [None] * L
    ct = round_to(co, dtype)
    for l in range(L - 1, -1, -1):
        if l < L - 1:
            ct = ct * (acts[l + 1] > 0).float()  # the ReLU of layer l
        dbs[l] = ct.sum(0)
        dws[l] = matmul_rounded(acts[l].T, ct, dtype)
        if l > 0:
            ct = matmul_rounded(ct, ws[l].T, dtype)
    ct_in = matmul_rounded(ct, ws[0].T, dtype)  # [sv | n | feat] columns
    df = ct_in[:, ds + 3:].to(dtype or torch.float32)
    dn = round_to(cn, dtype) + ct_in[:, ds:ds + 3]
    dot_cg = torch.sum(dn * g, dim=-1, keepdim=True)
    live = (sq > 1e-24).float()
    dg = dn / q - g * (dot_cg / (q * q * r)) * live
    return dws, dbs, dg, df


# -- the kernels -------------------------------------------------------------


def _lib():
    lib = build.load(NAME)
    lib.radiance_norm_launch.restype = ctypes.c_int
    lib.radiance_norm_launch.argtypes = [
        _c, _c, ctypes.c_int, _c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        _c, _c, _c, ctypes.c_int, _c,
    ]
    return lib


def _bwd_lib():
    lib = build.load(BWD_NAME)
    lib.radiance_norm_bwd_launch.restype = ctypes.c_int
    lib.radiance_norm_bwd_launch.argtypes = [
        _c, _c, ctypes.c_int, _c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        _c, _c, _c, _c, _c, _c, _c, ctypes.c_int, ctypes.c_int, _c, ctypes.c_int, _c,
    ]
    return lib


def _check_trunk(ws, ds, F, max_hidden=None):
    if ws[0].shape[0] != ds + 3 + F or ws[0].shape[0] > 304:
        raise ValueError(f"W0 has {ws[0].shape[0]} rows; expected ds + 3 + F <= 304")
    if any(w.shape[1] > 256 for w in ws[:-1]) or ws[-1].shape[1] > 4:
        raise ValueError("hidden widths must be <= 256 and the output <= 4")
    if max_hidden is not None and not 1 <= len(ws) - 1 <= max_hidden:
        raise ValueError(f"{len(ws) - 1} hidden layers; the backward kernel keeps 1 to "
                         f"{max_hidden} in shared memory")


def _inputs(g, sv, feat, dtype):
    """The operands at the kernel's types, checked."""
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    dev = g.device
    act = dtype or torch.float32
    N, ds = sv.shape
    F = feat.shape[1]
    sv = sv.to(act).contiguous()
    feat = feat.to(act).contiguous()
    build.require(g, "g", torch.float32, (N, 3), dev)
    build.require(sv, "sv", act, (N, ds), dev)
    build.require(feat, "feat", act, (N, F), dev)
    return sv, feat, act, N, ds, F


def _forward(ws, bs, g, sv, feat, dtype):
    """K3f on a CUDA tensor, its plain version on a CPU tensor."""
    if g.device.type == "cpu":
        return radiance_norm_plain(ws, bs, g, sv, feat, dtype)
    sv, feat, act, N, ds, F = _inputs(g, sv, feat, dtype)
    dev = g.device
    _check_trunk(ws, ds, F)
    P, desc = build.pack_mlp(ws, bs)
    build.require(P, "weights", torch.float32, P.shape, dev)
    rgb = torch.empty(N, ws[-1].shape[1], dtype=torch.float32, device=dev)
    nrm = torch.empty(N, 3, dtype=torch.float32, device=dev)
    if N == 0:
        return rgb, nrm
    lib = _lib()
    err = lib.radiance_norm_launch(
        build.ptr(g), build.ptr(sv), ds, build.ptr(feat), F, N, desc, build.ptr(P),
        build.ptr(rgb), build.ptr(nrm), int(dtype is not None), build.stream_ptr(dev),
    )
    build.check(lib, NAME, err)
    build.launches[NAME] += 1
    return rgb, nrm


def radiance_norm_bwd(ws, bs, g, sv, feat, co, cn, dtype=None):
    """K3b: (dws, dbs, dg (N, 3) float32, df (N, F) at the operand dtype).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which keeps at most two hidden layers (the bench's 2x256)."""
    if g.device.type == "cpu":
        return radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, dtype)
    sv, feat, act, N, ds, F = _inputs(g, sv, feat, dtype)
    dev = g.device
    _check_trunk(ws, ds, F, max_hidden=2)
    n_out = ws[-1].shape[1]
    co = co.to(act).contiguous()
    cn = cn.to(act).contiguous()
    build.require(co, "co", act, (N, n_out), dev)
    build.require(cn, "cn", act, (N, 3), dev)
    P, desc = build.pack_mlp(ws, bs)
    PT, _ = build.pack_mlp([w.t() for w in ws], bs)  # W^T of every layer, same offsets
    build.require(P, "weights", torch.float32, P.shape, dev)
    n_params = P.numel()
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    dg = torch.empty(N, 3, dtype=torch.float32, device=dev)
    df = torch.empty(N, F, dtype=act, device=dev)
    if N > 0:
        grid = min(build.num_sms(dev), -(-N // 64))  # csrc/common.cuh TILE_M rows a tile
        work = torch.empty(grid, n_params, dtype=torch.float32, device=dev)
        lib = _bwd_lib()
        err = lib.radiance_norm_bwd_launch(
            build.ptr(g), build.ptr(sv), ds, build.ptr(feat), F, N, desc, build.ptr(P),
            build.ptr(PT), build.ptr(co), build.ptr(cn), build.ptr(dg), build.ptr(df),
            build.ptr(work), grid, n_params, build.ptr(out), int(dtype is not None),
            build.stream_ptr(dev),
        )
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    else:
        out.zero_()
    dws, dbs = build.unpack_mlp(out, ws, bs)
    return dws, dbs, dg, df


class _RadianceNorm(torch.autograd.Function):
    """K3f forward, K3b backward, over (g, sv, feat) and the effective
    weights and biases; sv gets no gradient."""

    @staticmethod
    def forward(ctx, g, sv, feat, dtype, *wb):
        L = len(wb) // 2
        rgb, nrm = _forward(list(wb[:L]), list(wb[L:]), g, sv, feat, dtype)
        ctx.dtype, ctx.L = dtype, L
        ctx.save_for_backward(g, sv, feat, *wb)
        return rgb, nrm

    @staticmethod
    def backward(ctx, co, cn):
        g, sv, feat, *wb = ctx.saved_tensors
        L = ctx.L
        dws, dbs, dg, df = radiance_norm_bwd(wb[:L], wb[L:], g, sv, feat, co, cn, ctx.dtype)
        return (dg, None, df.to(feat.dtype), None, *dws, *dbs)


def radiance_norm(ws, bs, g, sv, feat, dtype=None):
    """(rgb_pre (N, 3) float32, normals (N, 3) float32).

    g (N, 3) the raw SDF gradient; sv (N, ds) = [points, view PE]; feat
    (N, F). ws/bs: effective weights with W0 rows [sv, normals, feat]. When
    an input requires grad (and grad is enabled), the call goes through the
    autograd Function: K3f forward, K3b backward. A CPU tensor takes the
    plain versions; a CUDA tensor launches the kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (g, feat, *ws, *bs)):
        return _RadianceNorm.apply(g, sv.detach(), feat, dtype, *ws, *bs)
    return _forward(ws, bs, g, sv, feat, dtype)

"""K8a: the split-operand radiance trunk on the raw SDF gradient, and its
backward.

K8a's forward replaces ``monosdf_tpu/ops/pallas_rgb_grad.py
_radiance_fwd_pallas`` (its ``pl.pallas_call`` at :379), its backward that
file's ``_radiance_bwd_pallas`` (:538); ``radiance_split`` is the
counterpart of the custom-VJP function there, reached from
``fields.rendering_apply_pallas`` in idr mode (``rgb_backend='pallas'``).
Kernels: ``csrc/radiance_split.cu`` and ``csrc/radiance_split_bwd.cu``.

The layer-0 input is [points, view PE | normals | features | code] (W0's
natural row order; the code when given), assembled in the kernel from the
four operands, so no wide concatenate reaches device memory. The normals
are the RAW SDF gradient (the plain rendering path's input; K3 normalises,
``ROADMAP.md`` §3). The normals, [points | view PE] and the code ship in
float32 and are rounded to the operand dtype at the product, the features
at the operand dtype; the rest of the numerics are K8b's
(``kernels/radiance_mlp.py``). The backward gives dW, db, the normals'
cotangent dn (N, 3) float32, the features' df at the operand dtype and the
code's dc (N, C) float32; the points and view PE get none (the TPU kernel
forms none: stop-gradient data in the reference).

Bound on the card: operations (about 3.0e10 FLOP forward per 100,352
samples with a 32-wide code, the backward about three times that). At bf16
both run on the tensor cores with K3's kernel bodies and K8a's segments
(sv, the normals and the code read as float32, no normalise step): the
forward is K3f's (csrc/radiance_tc.cuh ``rb_trunk_forward``, B operands
from ``radiance_norm.pack_fwd``), the backward K3b's two passes
(csrc/radiance_bwd_tc.cuh, ``radiance_norm.bwd_tc``), its float32 co kept
unrounded for the output layer's db and rounded for dW and the
propagation. float32 runs the SIMT trunk of csrc/radiance.cuh (float32
FMAs on the CUDA cores).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .radiance_mlp import (
    bwd_outputs,
    check_dtype,
    check_trunk,
    mlp_plain,
    opt_ptr,
    packed,
    trunk_bwd_plain,
)
from .radiance_norm import FWD_MAX_HIDDEN, bwd_tc, bwd_tc_argtypes, pack_fwd, tc_outputs
from .sdf_grad import _ints

NAME = "radiance_split"
BWD_NAME = "radiance_split_bwd"
_c = ctypes.c_void_p


def _h0(normals, sv, feat, code):
    parts = [sv.float(), normals.float(), feat.float()]
    if code is not None:
        parts.append(code.float())
    return torch.cat(parts, dim=-1)


def radiance_split_plain(ws, bs, normals, sv, feat, code=None, dtype=None):
    """K8a's function in plain PyTorch: the raw pre-activation (N, nout)."""
    return mlp_plain(ws, bs, _h0(normals, sv, feat, code), dtype)


def radiance_split_bwd_plain(ws, bs, normals, sv, feat, code, co, dtype=None):
    """K8a's backward in plain PyTorch: (dws, dbs, dn (N, 3) float32, df
    (N, F) at the operand dtype, dc (N, C) float32 or None)."""
    dws, dbs, ct = trunk_bwd_plain(ws, bs, _h0(normals, sv, feat, code), co.float(), dtype)
    ds, F = sv.shape[1], feat.shape[1]
    dc = ct[:, ds + 3 + F:] if code is not None else None
    return dws, dbs, ct[:, ds:ds + 3], ct[:, ds + 3:ds + 3 + F].to(dtype or torch.float32), dc


# -- the kernels -------------------------------------------------------------


def _lib():
    lib = build.load(NAME)
    _i, _pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.radiance_split_launch.restype = _i
    lib.radiance_split_launch.argtypes = [_c, _c, _i, _c, _i, _c, _i, _i, _pi, _c, _c, _c]
    lib.radiance_split_tc_launch.restype = _i
    lib.radiance_split_tc_launch.argtypes = [
        _c, _c, _i, _c, _i, _c, _i, _i, _pi, _c, _c, _pi, _c, _i, _c,
    ]
    return lib


def _bwd_lib():
    lib = build.load(BWD_NAME)
    _i, _pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.radiance_split_bwd_launch.restype = _i
    lib.radiance_split_bwd_launch.argtypes = [
        _c, _c, _i, _c, _i, _c, _i, _i, _pi, _c, _c, _c, _c, _c, _c, _c, _i, _i, _c, _c,
    ]
    lib.radiance_split_bwd_tc_launch.restype = _i
    lib.radiance_split_bwd_tc_launch.argtypes = bwd_tc_argtypes(4)  # co, dn, df, dc
    return lib


def _inputs(normals, sv, feat, code, dtype):
    """The operands at the kernel's types, checked: (normals, sv, feat,
    code, N, ds, F, C)."""
    check_dtype(dtype)
    dev = normals.device
    N, ds = sv.shape
    F = feat.shape[1]
    normals = normals.float().contiguous()
    sv = sv.float().contiguous()
    feat = feat.to(dtype or torch.float32).contiguous()
    build.require(normals, "normals", torch.float32, (N, 3), dev)
    build.require(sv, "sv", torch.float32, (N, ds), dev)
    build.require(feat, "feat", dtype or torch.float32, (N, F), dev)
    C = 0
    if code is not None:
        code = code.float().contiguous()
        C = code.shape[1]
        build.require(code, "code", torch.float32, (N, C), dev)
    return normals, sv, feat, code, N, ds, F, C


def _forward(ws, bs, normals, sv, feat, code=None, dtype=None):
    """K8a forward on a CUDA tensor, its plain version on a CPU tensor."""
    if normals.device.type == "cpu":
        return radiance_split_plain(ws, bs, normals, sv, feat, code, dtype)
    return _launch_forward(ws, bs, normals, sv, feat, code, dtype)


def _launch_forward(ws, bs, normals, sv, feat, code, dtype):
    normals, sv, feat, code, N, ds, F, C = _inputs(normals, sv, feat, code, dtype)
    dev = normals.device
    check_trunk(ws, ds + 3 + F + C)
    P, desc = packed(ws, bs, dev)
    out = torch.empty(N, ws[-1].shape[1], dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = _lib()
    if dtype is not None:  # the tensor cores
        if len(ws) - 1 > FWD_MAX_HIDDEN:
            raise ValueError(f"{len(ws) - 1} hidden layers > {FWD_MAX_HIDDEN}")
        wb, offs = pack_fwd(ws)
        err = lib.radiance_split_tc_launch(
            build.ptr(normals), build.ptr(sv), ds, build.ptr(feat), F, opt_ptr(code), C, N, desc,
            build.ptr(P), build.ptr(wb), _ints(offs), build.ptr(out), build.num_sms(dev),
            build.stream_ptr(dev),
        )
    else:
        err = lib.radiance_split_launch(
            build.ptr(normals), build.ptr(sv), ds, build.ptr(feat), F, opt_ptr(code), C, N, desc,
            build.ptr(P), build.ptr(out), build.stream_ptr(dev),
        )
    build.check(lib, NAME, err)
    build.launches[NAME] += 1
    return out


def radiance_split_bwd(ws, bs, normals, sv, feat, code, co, dtype=None):
    """K8a's backward: (dws, dbs, dn (N, 3) float32, df (N, F) at the
    operand dtype, dc (N, C) float32 or None). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16: the tensor-core
    passes), which keeps at most two hidden layers (the bench's 2x256)."""
    if normals.device.type == "cpu":
        return radiance_split_bwd_plain(ws, bs, normals, sv, feat, code, co, dtype)
    return _launch_backward(ws, bs, normals, sv, feat, code, co, dtype)


def _launch_backward(ws, bs, normals, sv, feat, code, co, dtype):
    normals, sv, feat, code, N, ds, F, C = _inputs(normals, sv, feat, code, dtype)
    dev = normals.device
    check_trunk(ws, ds + 3 + F + C, backward=True)
    co = co.float().contiguous()
    build.require(co, "co", torch.float32, (N, ws[-1].shape[1]), dev)
    dn = torch.empty(N, 3, dtype=torch.float32, device=dev)
    df = torch.empty(N, F, dtype=dtype or torch.float32, device=dev)
    dc = torch.empty(N, C, dtype=torch.float32, device=dev) if code is not None else None
    if N > 0 and dtype is not None:
        P, desc = packed(ws, bs, dev)
        lib = _bwd_lib()
        widths = (ds, 3, F, C)
        out = bwd_tc(lib, BWD_NAME, lib.radiance_split_bwd_tc_launch, ws, P, desc,
                     (normals, sv, ds, feat, F, code, C, N), (co, dn, df, dc), widths,
                     tc_outputs(widths))
        build.launches[BWD_NAME] += 1
    elif N > 0:
        P, PT, desc = packed(ws, bs, dev, transposed=True)
        out, work, grid = bwd_outputs(P, N, dev)
        lib = _bwd_lib()
        err = lib.radiance_split_bwd_launch(
            build.ptr(normals), build.ptr(sv), ds, build.ptr(feat), F, opt_ptr(code), C, N,
            desc, build.ptr(P), build.ptr(PT), build.ptr(co), build.ptr(dn), build.ptr(df),
            opt_ptr(dc), build.ptr(work), grid, P.numel(), build.ptr(out), build.stream_ptr(dev),
        )
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    else:
        out = torch.zeros(sum(t.numel() for t in (*ws, *bs)), dtype=torch.float32, device=dev)
    dws, dbs = build.unpack_mlp(out, ws, bs)
    return dws, dbs, dn, df, dc


class _RadianceSplit(torch.autograd.Function):
    """K8a forward, K8a backward, over (normals, sv, feat, code) and the
    effective weights and biases; sv gets no gradient."""

    @staticmethod
    def forward(ctx, normals, sv, feat, code, dtype, *wb):
        L = len(wb) // 2
        ctx.dtype, ctx.L = dtype, L
        ctx.save_for_backward(normals, sv, feat, code, *wb)
        return _forward(list(wb[:L]), list(wb[L:]), normals, sv, feat, code, dtype)

    @staticmethod
    def backward(ctx, co):
        normals, sv, feat, code, *wb = ctx.saved_tensors
        L = ctx.L
        dws, dbs, dn, df, dc = radiance_split_bwd(wb[:L], wb[L:], normals, sv, feat, code, co,
                                                  ctx.dtype)
        return (dn, None, df.to(feat.dtype), dc, None, *dws, *dbs)


def radiance_split(ws, bs, normals, sv, feat, code=None, dtype=None):
    """The raw last-layer pre-activation (N, nout) float32.

    normals (N, 3) the raw SDF gradient; sv (N, ds) = [points, view PE];
    feat (N, F); code (N, C) or None. ws/bs: effective weights with W0 rows
    [sv, normals, feat, code]. When an input requires grad (and grad is
    enabled), the call goes through the autograd Function: K8a forward, K8a
    backward. A CPU tensor takes the plain versions; a CUDA tensor launches
    the kernels."""
    diff = (normals, feat, *ws, *bs) + ((code,) if code is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        return _RadianceSplit.apply(normals, sv.detach(), feat, code, dtype, *ws, *bs)
    return _forward(ws, bs, normals, sv, feat, code, dtype)

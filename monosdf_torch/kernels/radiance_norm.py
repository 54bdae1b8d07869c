"""K3: radiance trunk with in-kernel normal normalisation and the per-image
code operand, and its backward.

K3f replaces ``monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_fwd_pallas``
(its ``pl.pallas_call`` at :708), K3b its ``_radiance_norm_bwd_pallas``
(``pl.pallas_call`` at :889); ``radiance_norm`` is the counterpart of that
file's custom_vjp function, reached from
``fields.rendering_apply_pallas_wide``. Kernels: ``csrc/radiance_norm.cu``
and ``csrc/radiance_norm_bwd.cu``, on the trunk of ``csrc/radiance.cuh``.

n = g / (sqrt(max(|g|^2, 1e-24)) + 1e-6), then the ReLU trunk over
``[points, view PE, n, features, code]`` (W0's natural row order; the code
(N, C) float32 when the model has per-image codes); returns the pre-sigmoid
rgb and n. With bf16 every operand is rounded to bf16 at the product and
each hidden pre-activation before its bias add and ReLU, as in the TPU
kernel.

The backward recomputes the trunk, runs the ReLU reverse sweep, takes the
layer-0 weight gradient from the normalised n, writes the feature cotangent
at the operand dtype and the code's in float32, and runs the normalise
backward with both normal cotangents summed (the ``normals`` output's and
the one through the radiance input): dg = dn/q - g (<dn, g> / (q^2 r))
[|g|^2 > 1e-24], r = sqrt(max(|g|^2, 1e-24)), q = r + 1e-6. The points and
view PE get no cotangent. dW0 comes back in W0's natural row order.

Bound on the card: operations, narrowly (forward about 3.0e10 FLOP per
100,352-sample batch with a 32-wide code, backward about three times that,
against ~62 MB of operands and outputs, ~19 us at 3.35 TB/s). The forward
keeps the 321-wide input row and the hidden layers in shared memory, so
device memory sees each input once and each output once. At bf16 it runs
on the tensor cores (csrc/radiance_norm.cu ``radiance_norm_kernel_tc``: the
body of K3b's pass-1 forward, csrc/radiance_tc.cuh, with its B operands
packed once per call by ``pack_fwd``; the top layer on the CUDA cores in
the SIMT kernel's order); float32 runs float32 FMAs on the CUDA cores, as
does the float32 backward. The bf16 backward runs on the tensor cores in
two passes (csrc/radiance_bwd_tc.cuh):
pass 1 recomputes the trunk, runs the reverse sweep and writes dg, df and
dc, storing the layers' bf16 inputs and cotangents in ``wgmma``'s layout
(~230 MB of scratch at the step's shapes); pass 2 sums ``A^T CT`` over the
rows; partials are summed in a fixed order (two runs, the same bits). Its
B operands are packed once per call (``pack_bwd``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nn import round_to
from . import build
from .radiance_mlp import (
    TILE_M,
    bwd_outputs,
    check_dtype,
    check_trunk,
    mlp_plain,
    opt_ptr,
    packed,
    trunk_bwd_plain,
)
from .sdf_grad import _ints
from .sdf_mlp import WG_N, pack_wgmma_b

NAME = "radiance_norm"
BWD_NAME = "radiance_norm_bwd"
_c = ctypes.c_void_p


def normalize(g: torch.Tensor) -> torch.Tensor:
    """Guarded normalisation g / (sqrt(max(|g|^2, 1e-24)) + 1e-6)."""
    sq = torch.sum(g * g, dim=-1, keepdim=True)
    return g / (torch.sqrt(torch.clamp(sq, min=1e-24)) + 1e-6)


def _h0(sv, n, feat, code):
    parts = [sv.float(), n, feat.float()]
    if code is not None:
        parts.append(code.float())
    return torch.cat(parts, dim=-1)


def radiance_norm_plain(ws, bs, g, sv, feat, dtype=None, code=None):
    """K3f's function in plain PyTorch: (rgb_pre (N, 3), normals (N, 3))."""
    n = normalize(g.float())
    return mlp_plain(ws, bs, _h0(sv, n, feat, code), dtype), n


def radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, dtype=None, code=None):
    """K3b's function in plain PyTorch, with its rounding points: (dws,
    dbs, dg (N, 3) float32, df (N, F) at the operand dtype, dc (N, C)
    float32 or None) for the cotangents co (N, 3) of rgb_pre and cn (N, 3)
    of the normals, both taken at the operand dtype."""
    g = g.float()
    sq = torch.sum(g * g, dim=-1, keepdim=True)
    r = torch.sqrt(torch.clamp(sq, min=1e-24))
    q = r + 1e-6
    ds, F = sv.shape[1], feat.shape[1]
    dws, dbs, ct_in = trunk_bwd_plain(ws, bs, _h0(sv, g / q, feat, code), round_to(co, dtype),
                                      dtype)
    df = ct_in[:, ds + 3:ds + 3 + F].to(dtype or torch.float32)
    dc = ct_in[:, ds + 3 + F:] if code is not None else None
    dn = round_to(cn, dtype) + ct_in[:, ds:ds + 3]
    dot_cg = torch.sum(dn * g, dim=-1, keepdim=True)
    live = (sq > 1e-24).float()
    dg = dn / q - g * (dot_cg / (q * q * r)) * live
    return dws, dbs, dg, df, dc


# -- the tensor-core backward's operands ---------------------------------------

BWD_KC = 64       # csrc/radiance_bwd_tc.cuh RB_KC: B rows per ring stage
BWD_SMALL = 2 * 256 + 4 + 256 * 4  # csrc/radiance_bwd_tc.cuh RB_SMALL
BWD_MAX_MATS = 8  # csrc/radiance_bwd_tc.cuh RB_MAX_MATS


@functools.lru_cache(maxsize=None)
def input_blocks(widths, outputs):
    """The input-cotangent blocks of the tensor-core backward: W0's rows
    that have a cotangent output (segments ``outputs`` of the input row,
    whose segment widths are ``widths``), grouped into blocks of at most
    256 (first fit, widest segment first; a wider segment is cut). Returns
    per block its runs of W0 rows (start, stop) and, per column, (segment <<
    16) | column in that segment."""
    starts = [sum(widths[:s]) for s in range(len(widths))]
    pieces = []
    for s in sorted(outputs, key=lambda s: -widths[s]):
        for c0 in range(0, widths[s], WG_N):
            pieces.append((s, c0, min(WG_N, widths[s] - c0)))
    blocks = []  # [(runs, codes)]
    for s, c0, w in pieces:
        blk = next((b for b in blocks if len(b[1]) + w <= WG_N), None)
        if blk is None:
            blk = ([], [])
            blocks.append(blk)
        blk[0].append((starts[s] + c0, starts[s] + c0 + w))
        blk[1].extend((s << 16) | c for c in range(c0, c0 + w))
    return tuple((tuple(runs), tuple(codes)) for runs, codes in blocks)


_routes: dict = {}  # (widths, outputs, device) -> the route table on the device
FWD_MAX_HIDDEN = 8  # csrc/radiance_tc.cuh RF_MAX_HIDDEN


def pack_fwd(ws):
    """K3f's, K8a's and K8b's bf16 B operands (csrc/radiance_tc.cuh): the
    hidden layers' W_l in ring order, ``BWD_KC`` rows a stage, as the first
    H operands of ``pack_bwd``; and each one's element offset."""
    return pack_wgmma_b(ws[:-1], BWD_KC)


def pack_bwd(ws, widths, outputs):
    """K3b's, K8a's and K8b's pass-1 B operands (csrc/radiance_bwd_tc.cuh), in ring
    order: the forward's W_l (l < H), the backward's W_l^T (l = H - 1 .. 1), then
    W0^T restricted to each input block's rows (``input_blocks``), each
    ``BWD_KC`` rows a ring stage. Returns (the bf16 buffer, offsets, depths
    K, number of blocks, the route table (blocks, 256) int32 on the weights'
    device: -1 where a column has no output). The route table is made once
    per device and shape, so a call copies nothing from the host."""
    H = len(ws) - 1
    blocks = input_blocks(tuple(widths), tuple(outputs))
    mats = [ws[l] for l in range(H)] + [ws[l].t() for l in range(H - 1, 0, -1)]
    mats += [torch.cat([ws[0][a:b] for a, b in runs]).t() for runs, _ in blocks]
    wb, offs = pack_wgmma_b(mats, BWD_KC)
    key = (tuple(widths), tuple(outputs), ws[0].device)
    if key not in _routes:
        route = torch.full((len(blocks), WG_N), -1, dtype=torch.int32)
        for b, (_, codes) in enumerate(blocks):
            route[b, :len(codes)] = torch.tensor(codes, dtype=torch.int32)
        _routes[key] = route.to(ws[0].device)
    return wb, offs, [m.shape[0] for m in mats], len(blocks), _routes[key]


# -- the kernels -------------------------------------------------------------


def _lib():
    lib = build.load(NAME)
    lib.radiance_norm_launch.restype = ctypes.c_int
    lib.radiance_norm_launch.argtypes = [
        _c, _c, ctypes.c_int, _c, ctypes.c_int, _c, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), _c, _c, _c, _c,
    ]
    lib.radiance_norm_tc_launch.restype = ctypes.c_int
    lib.radiance_norm_tc_launch.argtypes = [
        _c, _c, ctypes.c_int, _c, ctypes.c_int, _c, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), _c, _c, ctypes.POINTER(ctypes.c_int), _c, _c, ctypes.c_int,
        _c,
    ]
    return lib


def _bwd_lib():
    lib = build.load(BWD_NAME)
    _i, _pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.radiance_norm_bwd_launch.restype = _i
    lib.radiance_norm_bwd_launch.argtypes = [
        _c, _c, _i, _c, _i, _c, _i, _i, _pi, _c, _c, _c, _c, _c, _c, _c, _c, _i, _i, _c, _c,
    ]
    lib.radiance_norm_bwd_tc_launch.restype = _i
    lib.radiance_norm_bwd_tc_launch.argtypes = bwd_tc_argtypes(5)  # co, cn, dg, df, dc
    return lib


# the operands of K3b's and K8a's tensor-core entry points: (the normals'
# operand, sv, ds, feat, F, code, C, N)
SEGMENT_OPERANDS = (_c, _c, ctypes.c_int, _c, ctypes.c_int, _c, ctypes.c_int, ctypes.c_int)


def bwd_tc_argtypes(n_cot: int, operands=SEGMENT_OPERANDS):
    """The argument types of a tensor-core backward's C entry point (K3b's,
    K8a's, K8b's): the operands (ending with N), the packed B operands,
    ``n_cot`` cotangent pointers (inputs, then outputs), the scratch and
    the partials."""
    _i, _pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    return [*operands, _pi, _c, _c, _pi, _pi, _i, _i, _c, *[_c] * n_cot,
            ctypes.POINTER(_c), ctypes.POINTER(_c), _pi, _c, _i, _i, _c, _i, _i, _c, _c]


def _inputs(g, sv, feat, code, dtype):
    """The operands at the kernel's types, checked: (sv, feat, code, act, N,
    ds, F, C)."""
    check_dtype(dtype)
    dev = g.device
    act = dtype or torch.float32
    N, ds = sv.shape
    F = feat.shape[1]
    sv = sv.to(act).contiguous()
    feat = feat.to(act).contiguous()
    build.require(g, "g", torch.float32, (N, 3), dev)
    build.require(sv, "sv", act, (N, ds), dev)
    build.require(feat, "feat", act, (N, F), dev)
    C = 0
    if code is not None:
        code = code.float().contiguous()
        C = code.shape[1]
        build.require(code, "code", torch.float32, (N, C), dev)
    return sv, feat, code, act, N, ds, F, C


def _forward(ws, bs, g, sv, feat, dtype=None, code=None):
    """K3f on a CUDA tensor, its plain version on a CPU tensor."""
    if g.device.type == "cpu":
        return radiance_norm_plain(ws, bs, g, sv, feat, dtype, code)
    return _launch_forward(ws, bs, g, sv, feat, dtype, code)


def _launch_forward(ws, bs, g, sv, feat, dtype, code):
    sv, feat, code, act, N, ds, F, C = _inputs(g, sv, feat, code, dtype)
    dev = g.device
    check_trunk(ws, ds + 3 + F + C)
    P, desc = packed(ws, bs, dev)
    rgb = torch.empty(N, ws[-1].shape[1], dtype=torch.float32, device=dev)
    nrm = torch.empty(N, 3, dtype=torch.float32, device=dev)
    if N == 0:
        return rgb, nrm
    lib = _lib()
    if dtype is not None:  # the tensor cores
        if len(ws) - 1 > FWD_MAX_HIDDEN:
            raise ValueError(f"{len(ws) - 1} hidden layers > {FWD_MAX_HIDDEN}")
        wb, offs = pack_fwd(ws)
        err = lib.radiance_norm_tc_launch(
            build.ptr(g), build.ptr(sv), ds, build.ptr(feat), F, opt_ptr(code), C, N, desc,
            build.ptr(P), build.ptr(wb), _ints(offs), build.ptr(rgb), build.ptr(nrm),
            build.num_sms(dev), build.stream_ptr(dev),
        )
    else:
        err = lib.radiance_norm_launch(
            build.ptr(g), build.ptr(sv), ds, build.ptr(feat), F, opt_ptr(code), C, N, desc,
            build.ptr(P), build.ptr(rgb), build.ptr(nrm), build.stream_ptr(dev),
        )
    build.check(lib, NAME, err)
    build.launches[NAME] += 1
    return rgb, nrm


def radiance_norm_bwd(ws, bs, g, sv, feat, co, cn, dtype=None, code=None):
    """K3b: (dws, dbs, dg (N, 3) float32, df (N, F) at the operand dtype,
    dc (N, C) float32 or None). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (bf16: the tensor-core passes), which
    keeps at most two hidden layers (the bench's 2x256)."""
    if g.device.type == "cpu":
        return radiance_norm_bwd_plain(ws, bs, g, sv, feat, co, cn, dtype, code)
    return _launch_backward(ws, bs, g, sv, feat, co, cn, dtype, code)


def _launch_backward(ws, bs, g, sv, feat, co, cn, dtype, code):
    sv, feat, code, act, N, ds, F, C = _inputs(g, sv, feat, code, dtype)
    dev = g.device
    check_trunk(ws, ds + 3 + F + C, backward=True)
    co = co.to(act).contiguous()
    cn = cn.to(act).contiguous()
    build.require(co, "co", act, (N, ws[-1].shape[1]), dev)
    build.require(cn, "cn", act, (N, 3), dev)
    dg = torch.empty(N, 3, dtype=torch.float32, device=dev)
    df = torch.empty(N, F, dtype=act, device=dev)
    dc = torch.empty(N, C, dtype=torch.float32, device=dev) if code is not None else None
    if N > 0 and dtype is not None:
        P, desc = packed(ws, bs, dev)
        lib = _bwd_lib()
        widths = (ds, 3, F, C)
        out = bwd_tc(lib, BWD_NAME, lib.radiance_norm_bwd_tc_launch, ws, P, desc,
                     (g, sv, ds, feat, F, code, C, N), (co, cn, dg, df, dc), widths,
                     tc_outputs(widths))
        build.launches[BWD_NAME] += 1
    elif N > 0:
        P, PT, desc = packed(ws, bs, dev, transposed=True)
        out, work, grid = bwd_outputs(P, N, dev)
        lib = _bwd_lib()
        err = lib.radiance_norm_bwd_launch(
            build.ptr(g), build.ptr(sv), ds, build.ptr(feat), F, opt_ptr(code), C, N, desc,
            build.ptr(P), build.ptr(PT), build.ptr(co), build.ptr(cn), build.ptr(dg),
            build.ptr(df), opt_ptr(dc), build.ptr(work), grid, P.numel(), build.ptr(out),
            build.stream_ptr(dev),
        )
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    else:
        out = torch.zeros(sum(t.numel() for t in (*ws, *bs)), dtype=torch.float32, device=dev)
    dws, dbs = build.unpack_mlp(out, ws, bs)
    return dws, dbs, dg, df, dc


def bwd_tc(lib, name, launch, ws, P, desc, operands, cotangents, widths, outputs):
    """The tensor-core passes (csrc/radiance_bwd_tc.cuh) through ``launch``,
    the C entry point of K3b, K8a or K8b in ``lib``: pass 1 on one CTA per
    SM over 64-row tiles, storing each tile's h0, Y_l (l < H - 1) and CT_l
    (l < H) as 64-row blocks of wgmma's layout; pass 2 over the blocks'
    128-column slices and splits of the tiles; the ordered sums. operands:
    the entry point's operands, N last (K3b's and K8a's: the normals'
    operand, sv, ds, feat, F, code, C, N; K8b's: h0, d0, N); widths: the
    input row's segment widths; outputs: the segments with a cotangent
    output; cotangents: the entry point's cotangent tensors in its order
    (None: none). Returns the parameter gradients in ``build.pack_mlp``'s
    layout."""
    dev, N = P.device, operands[-1]
    H = len(ws) - 1
    n_small = sum(w.shape[1] for w in ws) + ws[-1].shape[0] * ws[-1].shape[1]
    if n_small > BWD_SMALL:
        raise ValueError(f"{n_small} bias and top-layer gradients > {BWD_SMALL}")
    wb, offs, ks, nblk, route = pack_bwd(ws, widths, outputs)
    if len(offs) > BWD_MAX_MATS:
        raise ValueError(f"{len(offs)} B operands > {BWD_MAX_MATS}")
    n_tiles = -(-N // TILE_M)
    blk = n_tiles * TILE_M
    kap = [-(-w.shape[0] // 128) * 128 for w in ws[:H]]  # A_l blocks: layer l's input
    scratch = torch.empty(blk * (sum(kap) + WG_N * H), dtype=torch.bfloat16, device=dev)
    ct_ptrs, a_ptrs = (_c * build.MAX_LAYERS)(), (_c * build.MAX_LAYERS)()
    off = 0
    for l in range(H):
        a_ptrs[l] = scratch[off:].data_ptr()
        off += blk * kap[l]
        ct_ptrs[l] = scratch[off:].data_ptr()
        off += blk * WG_N
    sms = build.num_sms(dev)
    grid1 = min(sms, n_tiles)
    blocks = sum(k // 128 for k in kap)
    splits = max(1, min(n_tiles, sms // blocks))
    part1 = torch.empty(grid1, n_small, dtype=torch.float32, device=dev)
    part2 = torch.empty(blocks * splits, 128, WG_N, dtype=torch.float32, device=dev)
    n_w = sum(w.shape[0] * w.shape[1] for w in ws[:H])
    out = torch.empty(P.numel(), dtype=torch.float32, device=dev)

    def arg(x):  # a tensor (or None) as its pointer, an int as itself
        return opt_ptr(x) if x is None or isinstance(x, torch.Tensor) else x

    err = launch(
        *map(arg, operands), desc, build.ptr(P), build.ptr(wb), _ints(offs), _ints(ks), len(offs),
        nblk, build.ptr(route), *map(arg, cotangents), ct_ptrs, a_ptrs, _ints(kap),
        build.ptr(part1), grid1, n_small, build.ptr(part2), splits, max(n_small, n_w),
        build.ptr(out), build.stream_ptr(dev),
    )
    build.check(lib, name, err)
    return out


def tc_outputs(widths):
    """The input segments of (sv, normals, feat, code) with a cotangent
    output in the tensor-core backward: all but sv, the code when given."""
    return (1, 2, 3) if widths[3] > 0 else (1, 2)


class _RadianceNorm(torch.autograd.Function):
    """K3f forward, K3b backward, over (g, sv, feat, code) and the effective
    weights and biases; sv gets no gradient."""

    @staticmethod
    def forward(ctx, g, sv, feat, code, dtype, *wb):
        L = len(wb) // 2
        rgb, nrm = _forward(list(wb[:L]), list(wb[L:]), g, sv, feat, dtype, code)
        ctx.dtype, ctx.L = dtype, L
        ctx.save_for_backward(g, sv, feat, code, *wb)
        return rgb, nrm

    @staticmethod
    def backward(ctx, co, cn):
        g, sv, feat, code, *wb = ctx.saved_tensors
        L = ctx.L
        dws, dbs, dg, df, dc = radiance_norm_bwd(wb[:L], wb[L:], g, sv, feat, co, cn, ctx.dtype,
                                                 code)
        return (dg, None, df.to(feat.dtype), dc, None, *dws, *dbs)


def radiance_norm(ws, bs, g, sv, feat, dtype=None, code=None):
    """(rgb_pre (N, 3) float32, normals (N, 3) float32).

    g (N, 3) the raw SDF gradient; sv (N, ds) = [points, view PE]; feat
    (N, F); code (N, C) or None. ws/bs: effective weights with W0 rows [sv,
    normals, feat, code]. When an input requires grad (and grad is
    enabled), the call goes through the autograd Function: K3f forward, K3b
    backward. A CPU tensor takes the plain versions; a CUDA tensor launches
    the kernels."""
    diff = (g, feat, *ws, *bs) + ((code,) if code is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        return _RadianceNorm.apply(g, sv.detach(), feat, code, dtype, *ws, *bs)
    return _forward(ws, bs, g, sv, feat, dtype, code)

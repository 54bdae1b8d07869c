"""K8b: the radiance ReLU trunk on one concatenated input row with the
input's cotangent (nerf mode), and the trunk pieces that K3 and K8a share.

K8b's forward replaces ``monosdf_tpu/ops/pallas_rgb_grad.py _fwd_pallas``
(its ``pl.pallas_call`` at :122), its backward that file's ``_bwd_pallas``
(:225); ``mlp_with_input_grad`` is the counterpart of the custom-VJP
function there (:952-981), reached from ``fields.rendering_apply_pallas``
in nerf mode on h0 = [view PE | features | code]. Kernels:
``csrc/radiance_mlp.cu`` and ``csrc/radiance_mlp_bwd.cu``.

Numerics, as the TPU kernel's: h0 (float32) rounded to the operand dtype
at the product, each hidden pre-activation rounded to it before the bias
add and the ReLU, the last layer float32 acc + bias (the raw
pre-activation). The backward takes the float32 cotangent co: the output
layer's db sums it unrounded, dW and the propagation take it rounded; each
lower cotangent gives db in float32 and is rounded for dW and the next
product; dh0 (N, d0) comes back in float32.

Bound on the card: operations (about 2.8e10 FLOP forward per 100,352 rows
at d0 = 283, the backward about three times that, against ~115 MB of
float32 input and output). At bf16 both run on the tensor cores with K3's
kernel bodies on one float32 segment, h0: the forward is K3f's
(csrc/radiance_tc.cuh ``rb_trunk_forward``, B operands from
``radiance_norm.pack_fwd``), the backward K3b's two passes
(csrc/radiance_bwd_tc.cuh, ``radiance_norm.bwd_tc``) with every column of
h0 a cotangent output (W0^T in blocks of at most 256 columns). float32
runs the SIMT trunk of csrc/radiance.cuh, which K3 and K8a share (float32
FMAs on the CUDA cores, the input row and the hidden layers in shared
memory).
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import matmul_rounded
from . import build
from .sdf_grad import _ints

NAME = "radiance_mlp"
BWD_NAME = "radiance_mlp_bwd"
TILE_M = 64      # csrc/common.cuh: rows a block takes
MAX_D0 = 336     # csrc/radiance.cuh LDH: the widest input row
MAX_HIDDEN = 2   # the backward kernels keep at most two hidden layers
_c = ctypes.c_void_p


# -- the plain versions -------------------------------------------------------


def trunk_hidden(ws, bs, h, dtype):
    """The inputs of every layer: [h0, relu(y_0), ..., relu(y_{L-2})], each
    pre-activation rounded to ``dtype`` before the bias add (bf16)."""
    acts = [h]
    for l in range(len(ws) - 1):
        acc = matmul_rounded(h, ws[l], dtype)
        y = (acc.to(dtype) + bs[l].to(dtype)).float() if dtype is not None else acc + bs[l]
        h = torch.relu(y)
        acts.append(h)
    return acts


def trunk_bwd_plain(ws, bs, h0, co, dtype=None):
    """The trunk's VJP for the cotangent co (float32, or already rounded):
    (dws, dbs, ct_in), ct_in (N, d0) float32 the input row's cotangent."""
    acts = trunk_hidden(ws, bs, h0, dtype)
    L = len(ws)
    dws, dbs = [None] * L, [None] * L
    ct = co.float()
    for l in range(L - 1, -1, -1):
        if l < L - 1:
            ct = ct * (acts[l + 1] > 0).float()  # the ReLU of layer l
        dbs[l] = ct.sum(0)
        dws[l] = matmul_rounded(acts[l].T, ct, dtype)
        ct = matmul_rounded(ct, ws[l].T, dtype)
    return dws, dbs, ct


def mlp_plain(ws, bs, h0, dtype=None):
    """K8b's function in plain PyTorch: the raw pre-activation (N, nout)."""
    h = trunk_hidden(ws, bs, h0.float(), dtype)[-1]
    return matmul_rounded(h, ws[-1], dtype) + bs[-1]


def mlp_bwd_plain(ws, bs, h0, co, dtype=None):
    """K8b's backward in plain PyTorch: (dws, dbs, dh0 (N, d0) float32)."""
    return trunk_bwd_plain(ws, bs, h0.float(), co.float(), dtype)


# -- launching the trunk kernels (K3, K8a, K8b) -------------------------------


def check_dtype(dtype):
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernels take float32 or bfloat16")


def check_trunk(ws, d0: int, backward: bool = False):
    """Raise unless the kernels take this trunk on a d0-wide input row."""
    if ws[0].shape[0] != d0 or d0 > MAX_D0:
        raise ValueError(f"W0 has {ws[0].shape[0]} rows; expected the input's {d0} <= {MAX_D0}")
    if any(w.shape[1] > 256 for w in ws[:-1]) or ws[-1].shape[1] > 4:
        raise ValueError("hidden widths must be <= 256 and the output <= 4")
    hidden = len(ws) - 1
    if hidden < 1 or (backward and hidden > MAX_HIDDEN):
        raise ValueError(f"{hidden} hidden layers; the kernels take 1 or more, the backward "
                         f"kernels keep at most {MAX_HIDDEN} in shared memory")


def packed(ws, bs, dev, transposed: bool = False):
    """The packed weights on ``dev`` and their descriptor; with
    ``transposed`` also W^T of every layer at the same offsets."""
    P, desc = build.pack_mlp(ws, bs)
    build.require(P, "weights", torch.float32, P.shape, dev)
    if not transposed:
        return P, desc
    PT, _ = build.pack_mlp([w.t() for w in ws], bs)
    return P, PT, desc


def bwd_outputs(P, N: int, dev):
    """The parameter-gradient buffer, the persistent grid and its per-block
    partials of a backward launch."""
    n_params = P.numel()
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    grid = max(1, min(build.num_sms(dev), -(-N // TILE_M)))
    work = torch.empty(grid, n_params, dtype=torch.float32, device=dev)
    return out, work, grid


def opt_ptr(t):
    return build.ptr(t) if t is not None else None


# -- K8b ----------------------------------------------------------------------


def _lib():
    lib = build.load(NAME)
    _i, _pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.radiance_mlp_launch.restype = _i
    lib.radiance_mlp_launch.argtypes = [_c, _i, _i, _pi, _c, _c, _c]
    lib.radiance_mlp_tc_launch.restype = _i
    lib.radiance_mlp_tc_launch.argtypes = [_c, _i, _i, _pi, _c, _c, _pi, _c, _i, _c]
    return lib


def _bwd_lib():
    from .radiance_norm import bwd_tc_argtypes

    lib = build.load(BWD_NAME)
    _i, _pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.radiance_mlp_bwd_launch.restype = _i
    lib.radiance_mlp_bwd_launch.argtypes = [_c, _i, _i, _pi, _c, _c, _c, _c, _c, _i, _i, _c, _c]
    lib.radiance_mlp_bwd_tc_launch.restype = _i
    lib.radiance_mlp_bwd_tc_launch.argtypes = bwd_tc_argtypes(2, (_c, _i, _i))  # co, dh0
    return lib


def _input(h0, dtype):
    check_dtype(dtype)
    h0 = h0.float().contiguous()
    return h0, h0.shape[0], h0.shape[1], h0.device


def _forward(ws, bs, h0, dtype=None):
    """K8b forward on a CUDA tensor, its plain version on a CPU tensor."""
    if h0.device.type == "cpu":
        return mlp_plain(ws, bs, h0, dtype)
    return _launch_forward(ws, bs, h0, dtype)


def _launch_forward(ws, bs, h0, dtype):
    h0, N, d0, dev = _input(h0, dtype)
    check_trunk(ws, d0)
    P, desc = packed(ws, bs, dev)
    out = torch.empty(N, ws[-1].shape[1], dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = _lib()
    if dtype is not None:  # the tensor cores
        from .radiance_norm import FWD_MAX_HIDDEN, pack_fwd

        if len(ws) - 1 > FWD_MAX_HIDDEN:
            raise ValueError(f"{len(ws) - 1} hidden layers > {FWD_MAX_HIDDEN}")
        wb, offs = pack_fwd(ws)
        err = lib.radiance_mlp_tc_launch(build.ptr(h0), d0, N, desc, build.ptr(P), build.ptr(wb),
                                         _ints(offs), build.ptr(out), build.num_sms(dev),
                                         build.stream_ptr(dev))
    else:
        err = lib.radiance_mlp_launch(build.ptr(h0), d0, N, desc, build.ptr(P), build.ptr(out),
                                      build.stream_ptr(dev))
    build.check(lib, NAME, err)
    build.launches[NAME] += 1
    return out


def mlp_with_input_grad_bwd(ws, bs, h0, co, dtype=None):
    """K8b's backward: (dws, dbs, dh0 (N, d0) float32). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (bf16: the
    tensor-core passes), which keeps at most two hidden layers."""
    if h0.device.type == "cpu":
        return mlp_bwd_plain(ws, bs, h0, co, dtype)
    return _launch_backward(ws, bs, h0, co, dtype)


def _launch_backward(ws, bs, h0, co, dtype):
    h0, N, d0, dev = _input(h0, dtype)
    check_trunk(ws, d0, backward=True)
    co = co.float().contiguous()
    build.require(co, "co", torch.float32, (N, ws[-1].shape[1]), dev)
    dh0 = torch.empty(N, d0, dtype=torch.float32, device=dev)
    if N > 0 and dtype is not None:
        from .radiance_norm import bwd_tc

        P, desc = packed(ws, bs, dev)
        lib = _bwd_lib()
        out = bwd_tc(lib, BWD_NAME, lib.radiance_mlp_bwd_tc_launch, ws, P, desc, (h0, d0, N),
                     (co, dh0), (d0,), (0,))
        build.launches[BWD_NAME] += 1
    elif N > 0:
        P, PT, desc = packed(ws, bs, dev, transposed=True)
        out, work, grid = bwd_outputs(P, N, dev)
        lib = _bwd_lib()
        err = lib.radiance_mlp_bwd_launch(
            build.ptr(h0), d0, N, desc, build.ptr(P), build.ptr(PT), build.ptr(co),
            build.ptr(dh0), build.ptr(work), grid, P.numel(), build.ptr(out),
            build.stream_ptr(dev),
        )
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    else:
        out = torch.zeros(sum(t.numel() for t in (*ws, *bs)), dtype=torch.float32, device=dev)
    dws, dbs = build.unpack_mlp(out, ws, bs)
    return dws, dbs, dh0


class _MlpInputGrad(torch.autograd.Function):
    """K8b forward, K8b backward, over h0 and the effective weights and biases."""

    @staticmethod
    def forward(ctx, h0, dtype, *wb):
        L = len(wb) // 2
        ctx.dtype, ctx.L = dtype, L
        ctx.save_for_backward(h0, *wb)
        return _forward(list(wb[:L]), list(wb[L:]), h0, dtype)

    @staticmethod
    def backward(ctx, co):
        h0, *wb = ctx.saved_tensors
        L = ctx.L
        dws, dbs, dh0 = mlp_with_input_grad_bwd(wb[:L], wb[L:], h0, co, ctx.dtype)
        return (dh0.to(h0.dtype), None, *dws, *dbs)


def mlp_with_input_grad(ws, bs, h0, dtype=None):
    """The raw last-layer pre-activation (N, nout) float32 of the ReLU trunk
    on h0 (N, d0). ws/bs: effective weights (in, out). When an input
    requires grad (and grad is enabled), the call goes through the autograd
    Function: K8b forward, K8b backward with the weight, bias and input
    cotangents. A CPU tensor takes the plain versions; a CUDA tensor
    launches the kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h0, *ws, *bs)):
        return _MlpInputGrad.apply(h0, dtype, *ws, *bs)
    return _forward(ws, bs, h0, dtype)

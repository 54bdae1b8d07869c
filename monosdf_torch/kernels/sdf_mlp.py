"""K1: the SDF MLP forward of the sampler's no-grad sweeps, and K1-PE, the
same kernel on raw points.

Replaces ``monosdf_tpu/ops/pallas_mlp.py fused_sdf_mlp`` (its
``pl.pallas_call`` at :310), reached from ``fields.sdf_value_pallas``; K1-PE
its ``multires`` form (``kernel_pe`` :140, through ``fused_sdf_mlp_nograd``
:332), reached from ``fields.sdf_value_pallas(pe_in_kernel=True)``. Kernel:
``csrc/sdf_mlp.cu``.

Bound on the card: operations. One sweep (131,072 points through the bench's
8x256 MLP, last layer cut to the SDF column) is about 1.3e11 FLOP against a
few MB of bf16 embedding in and one float per point out. In bf16 (the
sweeps' path) the kernel runs every hidden layer on the tensor cores
(``wgmma``): a persistent CTA per SM keeps a 128-row bf16 activation tile in
shared memory for all nine layers and streams the weights, packed once per
call as bf16 in the layout ``wgmma`` reads (``pack_wgmma_b``), through a
ring of bulk copies. The float32 instantiation, the check path, stays on
float32 FMAs on the CUDA cores.

Input: the (N, d0) layer-0 input, sent at the operand dtype: the positional
embedding (``sweep_pe_in_kernel=False``, the bench default), or in grid
mode [PE | the first levels' grid features, zero-padded], 71 wide; K1-PE
takes the raw (N, 3) points and computes the embedding in float32 inside the
kernel, as ``kernel_pe`` does. Output: (N, d_last) float32, rounded to bf16
when ``dtype`` is bf16, as the TPU kernel emits it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..nn import matmul_rounded, round_to
from ..ops.embedder import positional_encoding
from . import build

NAME = "sdf_mlp"
PE_NAME = "sdf_mlp_pe"  # K1-PE: the same library, its own launch count
SQRT2 = math.sqrt(2.0)
_c = ctypes.c_void_p


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta = 100, overflow-safe (pallas_mlp.py _softplus100)."""
    return torch.where(x > 0.2, x, torch.log1p(torch.exp(100.0 * torch.clamp(x, max=0.2))) / 100.0)


def sdf_mlp_plain(ws, bs, x, skip_in, dtype=None, round_input: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points.
    ``round_input`` False keeps x in float32 for the skip layers (each
    matmul still rounds its operands): K1-PE's embedding, as kernel_pe's."""
    x0 = round_to(x, dtype) if round_input else x.float()
    h = x0
    L = len(ws)
    for l in range(L):
        if l in skip_in:
            h = torch.cat([h, x0], dim=-1) / SQRT2
        acc = matmul_rounded(h, ws[l], dtype) + bs[l]
        h = softplus100(acc) if l < L - 1 else acc
    return round_to(h, dtype)


def sdf_mlp_pe_plain(ws, bs, x, multires: int, skip_in, dtype=None) -> torch.Tensor:
    """K1-PE's function in plain PyTorch: the port's positional encoding of
    the raw points x (N, 3) in float32, then ``sdf_mlp_plain``."""
    return sdf_mlp_plain(ws, bs, positional_encoding(x.float(), multires), skip_in, dtype,
                         round_input=False)


# -- the bf16 weights in wgmma's operand layout ------------------------------

WG_N = 256  # output columns of one tensor-core product (wgmma n256)
K1_KC = 64  # csrc/sdf_mlp.cu TC_KC: input rows per ring stage


def core_offset(r: int, c: int, R: int) -> int:
    """Element (r, c) of an R-row operand in shared memory: 8 x 8 tiles of
    128 contiguous bytes, 8-column groups outermost (csrc/wgmma.cuh)."""
    return ((c // 8) * (R // 8) + r // 8) * 64 + (r % 8) * 8 + c % 8


def pack_wgmma_b(mats, kc: int):
    """B operands (K_l, N_l), N_l <= 256, as one bf16 buffer in the layout the
    kernels' weight stages hold, and each one's element offset. B_l's rows
    are zero-padded to a multiple of 16, then of ``kc``, its columns to
    256; chunk j holds rows [j kc, j kc + kc) with element (k, n) at
    ``core_offset(n, k - j kc, 256)`` (K-major: 8 consecutive k of one n in
    16 bytes), so a ring stage is one contiguous copy."""
    parts, offs, off = [], [], 0
    for b in mats:
        K, N = b.shape
        if N > WG_N:
            raise ValueError(f"{N} columns > {WG_N}")
        kp = -(-K // 16) * 16  # wgmma's depth, 16
        nch = -(-kp // kc)
        full = torch.zeros(nch * kc, WG_N, dtype=torch.bfloat16, device=b.device)
        full[:K, :N] = b
        # (chunk, k // 8, k % 8, n // 8, n % 8) -> (chunk, k // 8, n // 8, n % 8, k % 8)
        parts.append(full.view(nch, kc // 8, 8, WG_N // 8, 8).permute(0, 1, 3, 4, 2).reshape(-1))
        offs.append(off)
        off += parts[-1].numel()
    if off >= 2**31:
        raise ValueError("packed weights exceed 2^31 elements")
    return torch.cat(parts), offs


class Packed(NamedTuple):
    """K1's weights packed once for many calls: ``build.pack_mlp``'s float32
    buffer and descriptor (biases, the narrow last layer, the float32
    kernel) and the hidden layers' bf16 B operands (the tensor-core kernel)
    with their offsets as a C array."""

    P: torch.Tensor
    desc: object
    wb: torch.Tensor
    wb_off: object


def pack(ws, bs, skip_in) -> Packed:
    P, desc = build.pack_mlp(ws, bs, tuple(skip_in))
    wb, offs = pack_wgmma_b(ws[:-1], K1_KC)
    offs = offs + [0] * (build.MAX_LAYERS - len(offs))
    return Packed(P, desc, wb, (ctypes.c_int * build.MAX_LAYERS)(*offs))


def _lib():
    lib = build.load(NAME)
    lib.sdf_mlp_launch.restype = ctypes.c_int
    lib.sdf_mlp_launch.argtypes = [_c, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int), _c, _c,
                                   ctypes.POINTER(ctypes.c_int), _c, ctypes.c_int, ctypes.c_int, _c]
    return lib


def check_mlp_dims(ws, skip_in, d0: int, last_max: int):
    """Raise unless the layer widths fit the kernels' shared-memory tiles."""
    if d0 > 80:  # csrc/common.cuh LD0
        raise ValueError(f"input width {d0} > 80")
    width = d0
    for l, w in enumerate(ws):
        expect = width + (d0 if l in skip_in else 0)
        if w.shape[0] != expect:
            raise ValueError(f"layer {l}: {w.shape[0]} inputs, expected {expect}")
        if w.shape[0] > 304:
            raise ValueError(f"layer {l}: {w.shape[0]} inputs > 304")
        limit = last_max if l == len(ws) - 1 else 256
        if w.shape[1] > limit:
            raise ValueError(f"layer {l}: {w.shape[1]} outputs > {limit}")
        width = w.shape[1]


def _launch(name, ws, bs, xin, d0, multires, skip_in, dtype, packed):
    dev = xin.device
    N = xin.shape[0]
    check_mlp_dims(ws, tuple(skip_in), d0, last_max=4)
    pk = packed if packed is not None else pack(ws, bs, skip_in)
    build.require(pk.P, "weights", torch.float32, pk.P.shape, dev)
    build.require(pk.wb, "bf16 weights", torch.bfloat16, pk.wb.shape, dev)
    out = torch.empty(N, ws[-1].shape[1], dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = _lib()
    err = lib.sdf_mlp_launch(build.ptr(xin), N, d0, multires, pk.desc, build.ptr(pk.P),
                             build.ptr(pk.wb), pk.wb_off, build.ptr(out), int(dtype is not None),
                             build.num_sms(dev), build.stream_ptr(dev))
    build.check(lib, name, err)
    build.launches[name] += 1
    return out


def _check_dtype(dtype):
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")


def sdf_mlp(ws, bs, x, skip_in, dtype=None, packed=None) -> torch.Tensor:
    """(N, d_last) float32 output of the SDF MLP on the embedding x (N, d0).

    ws/bs: effective weights (d_in, d_out) and biases; dtype None or bf16;
    packed: ``pack(ws, bs, skip_in)`` when the caller holds it.
    A CPU tensor takes the plain version; a CUDA tensor launches K1."""
    if x.device.type == "cpu":
        return sdf_mlp_plain(ws, bs, x, skip_in, dtype)
    _check_dtype(dtype)
    xin = x.to(dtype or torch.float32).contiguous()
    return _launch(NAME, ws, bs, xin, xin.shape[1], -1, skip_in, dtype, packed)


def sdf_mlp_pe(ws, bs, x, multires: int, skip_in, dtype=None, packed=None) -> torch.Tensor:
    """K1-PE: ``sdf_mlp`` on the raw points x (N, 3), the positional
    embedding (``multires`` frequencies) computed inside the kernel. A CPU
    tensor takes the plain version; a CUDA tensor launches K1-PE."""
    if x.device.type == "cpu":
        return sdf_mlp_pe_plain(ws, bs, x, multires, skip_in, dtype)
    _check_dtype(dtype)
    xin = x.float().contiguous()
    build.require(xin, "x", torch.float32, (xin.shape[0], 3), x.device)
    return _launch(PE_NAME, ws, bs, xin, 3 * (1 + 2 * multires), multires, skip_in, dtype, packed)

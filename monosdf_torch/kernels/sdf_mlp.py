"""K1: the SDF MLP forward of the sampler's no-grad sweeps.

Replaces ``monosdf_tpu/ops/pallas_mlp.py fused_sdf_mlp`` (its
``pl.pallas_call`` at :310), reached from ``fields.sdf_value_pallas``.
Kernel: ``csrc/sdf_mlp.cu``.

Bound on the card: operations. One sweep (131,072 points through the bench's
8x256 MLP, last layer cut to the SDF column) is about 1.3e11 FLOP against a
few MB of bf16 embedding in and one float per point out. The design keeps a
64-row activation tile in shared memory for all nine layers and streams each
layer's weights through shared memory, so device memory sees only the input
and the output; this first version computes with float32 FMAs on the CUDA
cores on bf16-rounded operands, not on the tensor cores.

Input: the (N, d0) layer-0 input, sent at the operand dtype: the positional
embedding (``sweep_pe_in_kernel=False``, the bench default), or in grid
mode [PE | the first levels' grid features, zero-padded], 71 wide. Output: (N, d_last) float32,
rounded to bf16 when ``dtype`` is bf16, as the TPU kernel emits it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..nn import matmul_rounded, round_to
from . import build

NAME = "sdf_mlp"
SQRT2 = math.sqrt(2.0)
_c = ctypes.c_void_p


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta = 100, overflow-safe (pallas_mlp.py _softplus100)."""
    return torch.where(x > 0.2, x, torch.log1p(torch.exp(100.0 * torch.clamp(x, max=0.2))) / 100.0)


def sdf_mlp_plain(ws, bs, x, skip_in, dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points."""
    x0 = round_to(x, dtype)
    h = x0
    L = len(ws)
    for l in range(L):
        if l in skip_in:
            h = torch.cat([h, x0], dim=-1) / SQRT2
        acc = matmul_rounded(h, ws[l], dtype) + bs[l]
        h = softplus100(acc) if l < L - 1 else acc
    return round_to(h, dtype)


def _lib():
    lib = build.load(NAME)
    lib.sdf_mlp_launch.restype = ctypes.c_int
    lib.sdf_mlp_launch.argtypes = [_c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                   _c, _c, ctypes.c_int, _c]
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


def sdf_mlp(ws, bs, x, skip_in, dtype=None, packed=None) -> torch.Tensor:
    """(N, d_last) float32 output of the SDF MLP on the embedding x (N, d0).

    ws/bs: effective weights (d_in, d_out) and biases; dtype None or bf16;
    packed: ``build.pack_mlp(ws, bs, skip_in)`` when the caller holds it.
    A CPU tensor takes the plain version; a CUDA tensor launches K1."""
    if x.device.type == "cpu":
        return sdf_mlp_plain(ws, bs, x, skip_in, dtype)
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    dev = x.device
    xin = x.to(dtype or torch.float32).contiguous()
    N, d0 = xin.shape
    check_mlp_dims(ws, tuple(skip_in), d0, last_max=4)
    P, desc = packed if packed is not None else build.pack_mlp(ws, bs, tuple(skip_in))
    build.require(P, "weights", torch.float32, P.shape, dev)
    out = torch.empty(N, ws[-1].shape[1], dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = _lib()
    err = lib.sdf_mlp_launch(build.ptr(xin), N, d0, desc, build.ptr(P), build.ptr(out),
                             int(dtype is not None), build.stream_ptr(dev))
    build.check(lib, NAME, err)
    build.launches[NAME] += 1
    return out

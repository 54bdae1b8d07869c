"""K6 and K5: the hash-grid encode forward and its table gradient.

K6 (``hash_encode_fwd``, ``csrc/hash_encode.cu``) replaces
``monosdf_tpu/ops/pallas_fold.py _build_quad_hash_impl`` (its
``pl.pallas_call`` at :353) and the gather and interpolation that read the
quad table it builds: the card reads the eight corners directly, so the
kernel is the whole encode, features and (for the differentiated forward)
their three spatial tangents. K5 (``hash_encode_bwd``,
``csrc/hash_encode_bwd.cu``) replaces ``fold_hash_levels`` (its
``pl.pallas_call`` at :196): the transpose of the encode and of its
linearisation, each corner's cotangent added to its table row atomically.

Both are bound by bytes: the corner reads (the bf16 table fits the card's
L2) and the float32 outputs. K6 runs one thread per active (point, level)
pair and writes the inactive levels' zero columns apart; K5 one warp per
level of 32 consecutive points, summing the bf16-rounded terms of
neighbouring lanes in one cell before one atomic (a float4 one where
corners c and c|1 share a 16-byte row pair), its atomics summing in a
run-dependent order. A level's ``idx % hms`` is a mask or a multiply-high
in both (``level_mod`` below is its host twin, which the tests hold to
``%``).

``encode_diff`` puts them under a ``torch.autograd.Function``: K6 with
tangents forward, K5 backward, the gradient going to the float32 table
parameter while the forward reads the table at its ``table_dtype``
(``ops.hashgrid.read_table``). The plain versions are
``ops.hashgrid.encode_flat`` and an ``index_add_`` of the same per-corner
terms; a wrapper takes them only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.hashgrid import HashGridConfig, corner_geometry, corner_weights, encode_flat, level_rules
from . import build

NAME = "hash_encode"
BWD_NAME = "hash_encode_bwd"
MAX_LEVELS = 32  # csrc/hashgrid.cuh HG_MAX_LEVELS
_c = ctypes.c_void_p


def level_magic(hms: int):
    """(mask, magic, shift) of a level of ``hms`` rows: a power of two takes
    ``idx & mask`` (magic 0); any other size ``idx - q * hms`` with the
    quotient from a 32-bit multiply-high, ``t = mulhi(magic, idx)``, ``q =
    ((idx - t) // 2 + t) >> shift`` (csrc/hashgrid.cuh level_mod)."""
    if hms & (hms - 1) == 0:
        return hms - 1, 0, 0
    shift = hms.bit_length() - 1
    return 0, ((1 << (33 + shift)) // hms + 1) % (1 << 32), shift


def level_mod(idx: np.ndarray, hms: int, mask: int, magic: int, shift: int) -> np.ndarray:
    """``idx % hms`` (uint32 ``idx``) as the kernels compute it from the
    level's (mask, magic, shift), in numpy uint64 arithmetic."""
    idx = idx.astype(np.uint64)
    if magic == 0:
        return idx & np.uint64(mask)
    t = (idx * np.uint64(magic)) >> np.uint64(32)
    q = (((idx - t) >> np.uint64(1)) + t) >> np.uint64(shift)
    return idx - q * np.uint64(hms)


def _i32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


@functools.lru_cache(maxsize=16)
def _levels(cfg: HashGridConfig, size: float, tangent_scale: float):
    """csrc/hashgrid.cuh HashLevels as (int desc, float desc), and the
    table's rows."""
    rules = level_rules(cfg)
    L = len(rules)
    if L > MAX_LEVELS:
        raise ValueError(f"{L} levels; the kernels take at most {MAX_LEVELS}")
    pad = [0] * (MAX_LEVELS - L)
    col = lambda i, f=int: [f(r[i]) for r in rules] + pad
    magics = [level_magic(r[1]) for r in rules]
    desc = [L] + col(0) + col(1) + col(4) + col(5) + col(6)
    for i in range(3):  # mask, magic, shift
        desc += [_i32(m[i]) for m in magics] + pad
    fdesc = col(2, float) + col(3, float) + [r[3] / (2.0 * size) * tangent_scale for r in rules] + pad
    return ((ctypes.c_int * len(desc))(*desc), (ctypes.c_float * len(fdesc))(*fdesc),
            cfg.table_size)


@functools.cache
def _lib(name: str):
    """The loaded library with its launch function's signature set."""
    lib = build.load(name)
    if name == NAME:
        fn = lib.hash_encode_launch
        fn.argtypes = [_c, _c, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_float, _c, _c, ctypes.c_int, _c]
    else:
        fn = lib.hash_encode_bwd_launch
        fn.argtypes = [_c, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_float, _c, _c, _c, ctypes.c_int, _c]
    fn.restype = ctypes.c_int
    return lib


def _check(cfg: HashGridConfig, table: torch.Tensor, x: torch.Tensor, rows: int):
    if cfg.level_dim != 2:
        raise ValueError(f"level_dim {cfg.level_dim}: the kernels take 2 channels")
    dt = torch.bfloat16 if cfg.table_dtype == "bfloat16" else torch.float32
    build.require(table, "table", dt, (rows * 2,), x.device)
    build.require(x, "x", torch.float32, (x.shape[0], 3), x.device)


hash_encode_fwd_plain = encode_flat  # K6's function in plain PyTorch


def hash_encode_fwd(table, cfg: HashGridConfig, x, size: float = 1.0, n_levels=None,
                    tangents: bool = False, tangent_scale: float = 1.0):
    """Features (N, L*C) float32 of x (N, 3) from the flat table (T*C,) at
    ``cfg.table_dtype``, levels at or after ``n_levels`` zero; with
    ``tangents`` also (3, N, L*C), the derivatives along each axis times
    ``tangent_scale``. A CPU tensor takes the plain version; a CUDA tensor
    launches K6."""
    if x.device.type == "cpu":
        return hash_encode_fwd_plain(table, cfg, x, size, n_levels, tangents, tangent_scale)
    desc, fdesc, rows = _levels(cfg, float(size), float(tangent_scale))
    _check(cfg, table, x, rows)
    N, L = x.shape[0], cfg.num_levels
    K = L if n_levels is None else min(n_levels, L)
    feat = torch.empty(N, 2 * L, dtype=torch.float32, device=x.device)
    tg = torch.empty(3, N, 2 * L, dtype=torch.float32, device=x.device) if tangents else None
    if N > 0:
        lib = _lib(NAME)
        err = lib.hash_encode_launch(build.ptr(table), build.ptr(x), N, K, desc, fdesc,
                                     float(size), build.ptr(feat),
                                     build.ptr(tg) if tg is not None else None,
                                     int(table.dtype == torch.bfloat16), build.stream_ptr(x.device))
        build.check(lib, NAME, err)
        build.launches[NAME] += 1
    return (feat, tg) if tangents else feat


def corner_terms(cfg: HashGridConfig, x, c_feat, c_tg, size: float = 1.0,
                 tangent_scale: float = 1.0):
    """Each corner's table row (8*L*N,) and cotangent term (8*L*N, C):
    c_feat W_c + sum_k c_tg_k dW_c/dx_k, rounded to bf16 for a bf16 table.
    K5 adds these into the table gradient; ``index_add_`` of them is its
    plain version."""
    L, C = cfg.num_levels, cfg.level_dim
    N = x.shape[0]
    idx, w, dw, inb = corner_geometry(cfg, x, size, L, tangent_scale)
    W, dW = corner_weights(w, dw)  # (8, L, N), (3, 8, L, N)
    cf = (c_feat.reshape(N, L, C) * inb[:, None, None]).permute(1, 0, 2)  # (L, N, C)
    u = W[..., None] * cf[None]
    if c_tg is not None:
        ct = (c_tg.reshape(3, N, L, C) * inb[None, :, None, None]).permute(0, 2, 1, 3)
        u = u + torch.einsum("jcln,jlnd->clnd", dW, ct)
    if cfg.table_dtype == "bfloat16":
        u = u.to(torch.bfloat16).float()
    return idx.reshape(-1), u.reshape(-1, C)


def hash_encode_bwd_plain(cfg: HashGridConfig, x, c_feat, c_tg=None, size: float = 1.0,
                          tangent_scale: float = 1.0):
    """K5's function in plain PyTorch: the flat float32 table gradient."""
    rows, u = corner_terms(cfg, x, c_feat, c_tg, size, tangent_scale)
    d = torch.zeros(cfg.table_size, cfg.level_dim, dtype=torch.float32, device=x.device)
    return d.index_add_(0, rows, u).reshape(-1)


def hash_encode_bwd(cfg: HashGridConfig, x, c_feat, c_tg=None, size: float = 1.0,
                    tangent_scale: float = 1.0):
    """The table gradient (T*C,) float32 of the features' cotangent c_feat
    (N, L*C) and the tangents' c_tg (3, N, L*C) or None. A CPU tensor takes
    the plain version; a CUDA tensor launches K5."""
    if x.device.type == "cpu":
        return hash_encode_bwd_plain(cfg, x, c_feat, c_tg, size, tangent_scale)
    dev, N, L = x.device, x.shape[0], cfg.num_levels
    if cfg.level_dim != 2:
        raise ValueError(f"level_dim {cfg.level_dim}: the kernels take 2 channels")
    build.require(x, "x", torch.float32, (N, 3), dev)
    cf = c_feat.float().contiguous()
    build.require(cf, "c_feat", torch.float32, (N, 2 * L), dev)
    ct = None
    if c_tg is not None:
        ct = c_tg.float().contiguous()
        build.require(ct, "c_tg", torch.float32, (3, N, 2 * L), dev)
    desc, fdesc, rows = _levels(cfg, float(size), float(tangent_scale))
    d = torch.zeros(rows * 2, dtype=torch.float32, device=dev)
    if N > 0:
        lib = _lib(BWD_NAME)
        err = lib.hash_encode_bwd_launch(build.ptr(x), N, desc, fdesc, float(size), build.ptr(cf),
                                         build.ptr(ct) if ct is not None else None, build.ptr(d),
                                         int(cfg.table_dtype == "bfloat16"), build.stream_ptr(dev))
        build.check(lib, BWD_NAME, err)
        build.launches[BWD_NAME] += 1
    return d


class _HashEncode(torch.autograd.Function):
    """K6 with tangents forward, K5 backward; the gradient goes to the
    float32 ``master`` table, shaped like it."""

    @staticmethod
    def forward(ctx, master, table, x, meta):
        cfg, size, tangent_scale = meta
        ctx.meta, ctx.shape = meta, master.shape
        ctx.save_for_backward(x)
        return hash_encode_fwd(table, cfg, x, size, None, True, tangent_scale)

    @staticmethod
    def backward(ctx, c_feat, c_tg):
        (x,) = ctx.saved_tensors
        cfg, size, tangent_scale = ctx.meta
        d = hash_encode_bwd(cfg, x, c_feat, c_tg, size, tangent_scale)
        return d.view(ctx.shape), None, None, None


def encode_diff(master, table, cfg: HashGridConfig, x, size: float = 1.0,
                tangent_scale: float = 1.0):
    """(features (N, L*C), tangents (3, N, L*C)) of x (N, 3) read from
    ``table`` (``ops.hashgrid.read_table`` of the grid whose parameter is
    ``master``). Under grad, with ``master`` requiring it, the call goes
    through the autograd Function (K6 forward, K5 backward)."""
    x = x.detach().contiguous()
    if torch.is_grad_enabled() and master.requires_grad:
        return _HashEncode.apply(master, table, x, (cfg, float(size), float(tangent_scale)))
    return hash_encode_fwd(table, cfg, x, size, None, True, tangent_scale)

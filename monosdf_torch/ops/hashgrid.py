"""Multiresolution hash-grid encoding (monosdf_tpu/ops/hashgrid.py).

Instant-NGP style with smoothstep corner weights ``s(v) = v^2 (3 - 2v)``, so
second derivatives exist and the eikonal loss differentiates through the
encoder. Per level: scale ``exp2(level * S) * H - 1`` with S =
log2(per_level_scale); a dense linear index while the level grid fits its
table, else a hash (``hash_scheme``: the reference's xor of primes, or
``'add'``, x + y*P1 + z*P2 with the primes reduced mod 2^19); both taken
modulo the level's table size. Points outside [0, 1]^3 encode to zero, with
zero gradient.

The JAX package's table knobs ``layout``, ``scatter_impl``, ``fold_impl``,
``build_impl``, ``gather_chunks`` and ``sweep_oct_levels`` choose TPU
layouts of the same values; they are accepted here and change nothing.
``hash_scheme`` and ``table_dtype`` change values and are honoured:
with ``table_dtype='bfloat16'`` the corner values are read at bf16 and
combined in float32 with float32 weights, and each corner's cotangent is
rounded to bf16 before the float32 table-gradient sum, as the JAX package's
quad/fold path computes it.

``hash_encode`` is the plain path: PyTorch operations that autograd
differentiates once and twice, in the table and in the points. The kernel
path (``kernels/hash_encode.py``) computes the same features and, for the
differentiated forward, their three spatial tangents in one kernel, and the
table gradient in another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..nn import round_to

_PRIMES = (1, 2654435761, 805459861)
# the xor primes reduced mod 2^19: the same mixing for power-of-two hashed
# levels, and x + y*P1 + z*P2 stays below 2^32 for coordinates <= 2048
_ADD_MULTS = (1, 2654435761 % (1 << 19), 805459861 % (1 << 19))
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int | None = 2048
    table_dtype: str = "float32"  # 'float32' or 'bfloat16'
    scatter_impl: str = "flat"
    hash_scheme: str = "xor"  # 'xor' or 'add'
    layout: str = "rows"  # 'rows', 'quad' or 'oct'
    fold_impl: str = "xla"
    build_impl: str = "xla"
    param_flat: bool = False  # the table as one (T*C,) vector instead of (T, C)
    gather_chunks: int = 1
    sweep_oct_levels: int = 0

    def __post_init__(self):
        if self.input_dim != 3:
            raise NotImplementedError("the port encodes 3-D points")
        if self.hash_scheme not in ("xor", "add"):
            raise ValueError(f"hash_scheme {self.hash_scheme!r}: 'xor' or 'add'")
        if self.table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"table_dtype {self.table_dtype!r}: 'float32' or 'bfloat16'")

    @property
    def scale(self) -> float:
        if self.desired_resolution is not None:
            return float(np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                                 / (self.num_levels - 1)))
        return float(self.per_level_scale)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_params(self):
        """Per level (offset, hashmap_size, resolution, scale), as the JAX
        package computes them (float64 numpy)."""
        max_params = 2**self.log2_hashmap_size
        S = np.log2(self.scale)
        out, offset = [], 0
        for lvl in range(self.num_levels):
            res_alloc = int(np.ceil(self.base_resolution * self.scale**lvl))
            params_in_level = min(max_params, res_alloc**self.input_dim)
            fscale = float(np.exp2(lvl * S) * self.base_resolution - 1.0)
            out.append((offset, params_in_level, int(np.ceil(fscale)) + 1, fscale))
            offset += params_in_level
        return out

    @property
    def table_size(self) -> int:
        off, size, _, _ = self.level_params()[-1]
        return off + size


def level_rules(cfg: HashGridConfig):
    """Per level (offset, hms, res, fscale, s1, s2, xor): the corner index
    of corner (x, y, z) is (x + y*s1 + z*s2) mod hms, or with ``xor``
    (x ^ y*P1 ^ z*P2) mod hms in uint32 arithmetic. Dense levels (res^3 <=
    hms) take the linear strides (res, res^2) under both schemes."""
    out = []
    for off, hms, res, fscale in cfg.level_params():
        if res**cfg.input_dim <= hms:
            out.append((off, hms, res, fscale, res, res * res, False))
        elif cfg.hash_scheme == "add":
            out.append((off, hms, res, fscale, _ADD_MULTS[1] % hms, _ADD_MULTS[2] % hms, False))
        else:
            out.append((off, hms, res, fscale, 0, 0, True))
    return out


class HashGrid(nn.Module):
    """The hash table parameter ``embeddings``: (T, C), or (T*C,) with
    ``param_flat``."""

    def __init__(self, cfg: HashGridConfig, device=None):
        super().__init__()
        shape = (cfg.table_size * cfg.level_dim,) if cfg.param_flat else (cfg.table_size,
                                                                            cfg.level_dim)
        self.embeddings = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def init_hashgrid(cfg: HashGridConfig, generator: torch.Generator, device=None) -> HashGrid:
    """Embeddings ~ U(-1e-4, 1e-4), drawn on the CPU from ``generator``."""
    grid = HashGrid(cfg, device)
    with torch.no_grad():
        u = torch.rand(grid.embeddings.shape, generator=generator)
        grid.embeddings.copy_((u * 2.0 - 1.0) * 1e-4)
    return grid


def read_table(grid: HashGrid, cfg: HashGridConfig) -> torch.Tensor:
    """The table the encodes of one render or step read: the flat
    embeddings at ``table_dtype`` (one bf16 copy, or the float32 parameter
    itself), detached. The gradient goes to the float32 parameter."""
    emb = grid.embeddings.detach().reshape(-1)
    return emb.to(torch.bfloat16) if cfg.table_dtype == "bfloat16" else emb


def smoothstep(v):
    return v * v * (3.0 - 2.0 * v)


# corner c has offset bit d = (c >> d) & 1 along axis d (x fastest)
_BITS = np.array([[(c >> d) & 1 for d in range(3)] for c in range(8)], dtype=np.int64)


def corner_geometry(cfg: HashGridConfig, x: torch.Tensor, size: float, n_levels: int,
                    tangent_scale: float = 1.0):
    """Per level and point of x (N, 3), for the first ``n_levels`` levels:
    the 8 corners' table rows (8, K, N) int64 (level offsets added), the
    smoothstep weights w (K, N, 3), their derivatives along each axis dw
    (K, N, 3) (d w / d x times ``tangent_scale``), and the in-box mask (N,)
    float. w depends on x through differentiable operations."""
    rules = level_rules(cfg)[:n_levels]
    dev, dt = x.device, x.dtype
    col = lambda i, dtype: torch.tensor([r[i] for r in rules], dtype=dtype, device=dev)[:, None, None]
    x01 = (x + size) / (2.0 * size)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    fscale = col(3, torch.float32).to(dt)
    pos = x01[None] * fscale  # (K, N, 3)
    pos_grid = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), col(2, torch.float32).to(dt))
    v = torch.clamp(pos - pos_grid.detach(), 0.0, 1.0)
    w = smoothstep(v)
    dw = (6.0 * v * (1.0 - v)).detach() * (fscale / (2.0 * size) * tangent_scale)

    cg = pos_grid.detach().to(torch.int64)[None] + torch.from_numpy(_BITS).to(dev)[:, None, None]
    s1, s2, hms = col(4, torch.int64)[None], col(5, torch.int64)[None], col(1, torch.int64)[None]
    lin = (cg[..., 0] + cg[..., 1] * s1[..., 0] + cg[..., 2] * s2[..., 0]) & _MASK32
    xor = (cg[..., 0] * _PRIMES[0]) ^ ((cg[..., 1] * _PRIMES[1]) & _MASK32) ^ (
        (cg[..., 2] * _PRIMES[2]) & _MASK32)
    is_xor = col(6, torch.bool)[None, ..., 0]
    idx = torch.where(is_xor, xor, lin) % hms[..., 0] + col(0, torch.int64)[None, ..., 0]
    return idx, w, dw, (~oob).to(dt)


def corner_weights(w, dw):
    """Corner weights W (8, K, N) = prod_d (w_d or 1 - w_d) and their
    derivatives dW (3, 8, K, N) along each axis."""
    bits = torch.from_numpy(_BITS).to(w.device).bool()
    f = [torch.where(bits[:, d, None, None], w[None, ..., d], 1.0 - w[None, ..., d])
         for d in range(3)]
    df = [torch.where(bits[:, d, None, None], dw[None, ..., d], -dw[None, ..., d])
          for d in range(3)]
    W = f[0] * f[1] * f[2]
    dW = torch.stack([df[0] * f[1] * f[2], f[0] * df[1] * f[2], f[0] * f[1] * df[2]])
    return W, dW


def encode_flat(table: torch.Tensor, cfg: HashGridConfig, x: torch.Tensor, size: float = 1.0,
                n_levels: int | None = None, tangents: bool = False, tangent_scale: float = 1.0):
    """Features (N, L*C) of x (N, 3) from the table as one flat vector (T*C,)
    at float32 or bf16, levels at or after ``n_levels`` zero; with
    ``tangents`` also their derivatives along each axis (3, N, L*C) times
    ``tangent_scale``. Corner values are read at the table's dtype and
    combined in float32: a float32 table is rounded as it is read, so the
    gradient sums in float32 over corner cotangents rounded to bf16.
    Differentiable in the table and, through the weights, in x (the
    kernels' plain versions and the plain path)."""
    L, C = cfg.num_levels, cfg.level_dim
    K = L if n_levels is None else min(n_levels, L)
    idx, w, dw, inb = corner_geometry(cfg, x, size, K, tangent_scale)
    read = torch.bfloat16 if cfg.table_dtype == "bfloat16" else None
    vals = round_to(table.reshape(-1, C).float()[idx], read)  # (8, K, N, C)
    W, dW = corner_weights(w, dw)
    feat = torch.einsum("ckn,cknd->nkd", W, vals) * inb[:, None, None]  # (N, K, C)
    pad = lambda t: torch.nn.functional.pad(t.reshape(*t.shape[:-2], K * C), (0, (L - K) * C))
    if not tangents:
        return pad(feat)
    tg = torch.einsum("jckn,cknd->jnkd", dW, vals) * inb[None, :, None, None]
    return pad(feat), pad(tg)


def hash_encode(params: HashGrid, cfg: HashGridConfig, x: torch.Tensor, size: float = 1.0,
                n_levels: int | None = None, tangents: bool = False):
    """Encode points in [-size, size]^3: x (..., 3) -> (..., L*C), and with
    ``tangents`` the features' derivatives along each axis (3, ..., L*C).
    ``n_levels`` keeps the first levels at the full schedule's geometry and
    zeroes the rest (the sampler's sweeps). The plain path: the table is
    read at ``table_dtype`` and the result is differentiable in the table
    and in x (twice)."""
    prefix = x.shape[:-1]
    out = encode_flat(params.embeddings.reshape(-1), cfg, x.reshape(-1, 3), size, n_levels,
                      tangents)
    if tangents:
        return out[0].reshape(*prefix, -1), out[1].reshape(3, *prefix, -1)
    return out.reshape(*prefix, -1)

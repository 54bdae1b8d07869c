"""Minimal NN layer library (counterpart of monosdf_tpu/nn.py).

A linear layer is an ``nn.Module`` whose parameters carry the JAX pytree's
names: weight norm stays explicit as ``(g, v, b)`` (``w, b`` without it),
with ``v`` stored ``(in, out)`` as in the JAX package, so application is a
plain ``x @ w`` and the weight bridge copies arrays as they are.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """(1/beta) * log(1 + exp(beta*x)), as ``jax.nn.softplus(beta*x)/beta``
    (linear above beta*x = 20, where the two differ by < 1e-10 relative).
    Its derivative is the sigmoid, so the eikonal loss's double backward
    stays finite (``torch.logaddexp``'s gives NaN for large beta*x)."""
    return torch.nn.functional.softplus(x, beta=beta, threshold=20.0)


class Linear(nn.Module):
    """Weight-normalised linear layer: ``w = v * g / (|v|_col + 1e-16)``.

    Parameters are created empty on ``device``; ``init_linear`` and
    ``geometric_linear_init`` fill them, ``params.load_jax_params`` copies
    them from a JAX pytree."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool = True,
                 device=None):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.weight_norm = weight_norm
        kw = {"device": device, "dtype": torch.float32}
        if weight_norm:
            self.v = nn.Parameter(torch.empty(d_in, d_out, **kw))
            self.g = nn.Parameter(torch.empty(d_out, **kw))
        else:
            self.w = nn.Parameter(torch.empty(d_in, d_out, **kw))
        self.b = nn.Parameter(torch.empty(d_out, **kw))

    def effective_weight(self) -> torch.Tensor:
        """The (in, out) weight with weight norm resolved (per output unit)."""
        if not self.weight_norm:
            return self.w
        norm = torch.linalg.vector_norm(self.v, dim=0, keepdim=True)
        return self.v * (self.g[None, :] / (norm + 1e-16))


def round_to(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """x rounded to ``dtype`` (bf16) and held as float32; float32 as is."""
    return x.to(dtype).float() if dtype is not None else x.float()


def matmul_rounded(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype`` (bf16) and the sum
    kept in float32. A product of two bf16 values is exact in float32, so
    this is the mixed-precision product the kernels compute."""
    return round_to(x, dtype) @ round_to(w, dtype)


def apply_linear(lin: Linear, x: torch.Tensor, dtype=None,
                 keep_dtype: bool = False) -> torch.Tensor:
    """Weight-norm linear (monosdf_tpu nn.apply_linear). With ``dtype`` the
    operands are rounded to it and the sum stays float32; ``keep_dtype``
    rounds the product to ``dtype`` and adds the bias there, so the output
    is a ``dtype`` tensor."""
    w = lin.effective_weight()
    if dtype is None:
        return x @ w + lin.b
    y = matmul_rounded(x, w, dtype)
    if keep_dtype:
        return y.to(dtype) + lin.b.to(dtype)
    return y + lin.b


@torch.no_grad()
def _set_weight_norm(lin: Linear, w: torch.Tensor, b: torch.Tensor):
    if lin.weight_norm:
        lin.v.copy_(w)
        lin.g.copy_(torch.linalg.vector_norm(w, dim=0))
    else:
        lin.w.copy_(w)
    lin.b.copy_(b)


def init_linear(lin: Linear, generator: torch.Generator):
    """torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias (drawn on the CPU, then copied to the layer's device)."""
    d_in, d_out = lin.d_in, lin.d_out
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand(d_in, d_out, generator=generator) * 2 - 1) * bound
    b = (torch.rand(d_out, generator=generator) * 2 - 1) * bound
    _set_weight_norm(lin, w, b)


def geometric_linear_init(
    lin: Linear,
    generator: torch.Generator,
    layer_idx: int,
    num_layers: int,
    dims0: int,
    multires: int,
    skip_in: tuple,
    bias: float,
    inside_outside: bool,
):
    """SAL/IGR geometric initialisation of one SDF-MLP layer
    (monosdf_tpu nn.geometric_linear_init; reference network.py:51-70)."""
    d_in, d_out = lin.d_in, lin.d_out
    normal = lambda *shape: torch.randn(*shape, generator=generator)
    if layer_idx == num_layers - 2:  # last layer -> SDF head
        mean = math.sqrt(math.pi) / math.sqrt(d_in)
        if inside_outside:
            mean, b_val = -mean, bias
        else:
            b_val = -bias
        w = mean + 0.0001 * normal(d_in, d_out)
        b = torch.full((d_out,), b_val)
    elif multires > 0 and layer_idx == 0:
        # zero the PE channels; N(0, sqrt(2)/sqrt(out)) on raw xyz
        w = torch.zeros(d_in, d_out)
        w[:3, :] = math.sqrt(2.0) / math.sqrt(d_out) * normal(3, d_out)
        b = torch.zeros(d_out)
    elif multires > 0 and layer_idx in skip_in:
        w = math.sqrt(2.0) / math.sqrt(d_out) * normal(d_in, d_out)
        w[-(dims0 - 3):, :] = 0.0  # zero the concatenated PE tail
        b = torch.zeros(d_out)
    else:
        w = math.sqrt(2.0) / math.sqrt(d_out) * normal(d_in, d_out)
        b = torch.zeros(d_out)
    _set_weight_norm(lin, w, b)

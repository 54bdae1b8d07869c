"""SDF and radiance field networks (monosdf_tpu/models/fields.py).

One ImplicitNetConfig covers the pure-MLP and the hash-grid variant
(``use_grid``: the trunk's input is [PE(x) | grid features of x /
divide_factor], no bounding-sphere clamp). The networks are ``nn.Module``s
whose layers ``lin0, lin1, ...`` (and the grid's ``encoding.embeddings``)
carry the JAX pytree's names; the functions below take the module as
``params``, as the JAX functions take the pytree. ``*_pallas*`` functions
run a kernel (``kernels/``) on a CUDA tensor and its plain version on a CPU
tensor; the others are the plain path (the JAX package's ``jnp`` backends).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..kernels.hash_encode import encode_diff, hash_encode_fwd
from ..kernels.radiance_mlp import mlp_with_input_grad
from ..kernels.radiance_norm import radiance_norm
from ..kernels.radiance_split import radiance_split
from ..kernels.sdf_grad import pe_with_tangents, sdf_mlp_with_grad
from ..kernels.sdf_grad_grid import sdf_mlp_with_grad_in
from ..kernels.sdf_mlp import pack as pack_sweep
from ..kernels.sdf_mlp import sdf_mlp, sdf_mlp_pe
from ..nn import Linear, apply_linear, geometric_linear_init, init_linear, softplus_beta
from ..ops.embedder import pe_dim, positional_encoding
from ..ops.hashgrid import HashGridConfig, hash_encode, init_hashgrid, read_table


# ---------------------------------------------------------------------------
# Implicit (SDF) network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImplicitNetConfig:
    feature_vector_size: int = 256
    sdf_bounding_sphere: float = 1.1  # 0.0 disables the sphere clamp
    d_in: int = 3
    d_out: int = 1
    dims: tuple = (256, 256)
    geometric_init: bool = True
    bias: float = 0.9
    skip_in: tuple = ()
    weight_norm: bool = True
    multires: int = 6
    sphere_scale: float = 1.0
    inside_outside: bool = True
    # hash-grid variant (reference ImplicitNetworkGrid)
    use_grid: bool = False
    use_grid_feature: bool = True  # False: zeros in the grid features' place
    divide_factor: float = 1.5
    grid: HashGridConfig = HashGridConfig()

    @property
    def grid_feature_dim(self) -> int:
        return self.grid.output_dim if self.use_grid else 0

    @property
    def input_dim(self) -> int:
        """Width of the trunk's input: PE(x) [+ grid features]."""
        return pe_dim(self.multires, self.d_in) + self.grid_feature_dim

    @property
    def layer_dims(self) -> tuple:
        return (self.input_dim, *self.dims, self.d_out + self.feature_vector_size)

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims)


class ImplicitNet(nn.Module):
    """The SDF MLP: layers ``lin0 .. lin{num_layers-2}`` (weight-normalised),
    and in grid mode the hash grid ``encoding``."""

    def __init__(self, cfg: ImplicitNetConfig, device=None):
        super().__init__()
        dims = cfg.layer_dims
        for l in range(cfg.num_layers - 1):
            out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
            self.add_module(f"lin{l}", Linear(dims[l], out_dim, cfg.weight_norm, device))

    def layers(self):
        return [m for name, m in self._modules.items() if name.startswith("lin")]


def init_implicit_net(cfg: ImplicitNetConfig, generator: torch.Generator, device=None):
    net = ImplicitNet(cfg, device)
    for l, lin in enumerate(net.layers()):
        if cfg.geometric_init:
            geometric_linear_init(lin, generator, l, cfg.num_layers, cfg.layer_dims[0],
                                  cfg.multires, tuple(cfg.skip_in), cfg.bias, cfg.inside_outside)
        else:
            init_linear(lin, generator)
    if cfg.use_grid:
        net.encoding = init_hashgrid(cfg.grid, generator, device)
    return net


def effective_linear_weights(params: nn.Module):
    """Effective (W, b) lists with weight norm resolved, for the kernels."""
    lins = params.layers()
    return [lin.effective_weight() for lin in lins], [lin.b for lin in lins]


def implicit_apply(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                   dtype=None, max_level: int | None = None) -> torch.Tensor:
    """x (..., 3) -> raw net output (..., 1 + feature_vector_size).
    ``dtype`` (bf16): operands rounded, sums float32, hidden outputs bf16.
    ``max_level`` (grid mode): only the first grid levels, the rest zero
    (the sampler's sweeps)."""
    inp = _net_input(params, cfg, x, max_level)
    h = inp
    for l, lin in enumerate(params.layers()):
        if l in cfg.skip_in:
            h = torch.cat([h, inp.to(h.dtype)], dim=-1) / math.sqrt(2.0)
        last = l == cfg.num_layers - 2
        h = apply_linear(lin, h, dtype=dtype, keep_dtype=not last)
        if not last:
            h = softplus_beta(h, 100.0)
    return h.float()


def _clamp_sdf(cfg: ImplicitNetConfig, sdf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bounding-sphere SDF clamp so that every ray eventually occludes. The
    grid variant does not clamp (reference ImplicitNetworkGrid)."""
    if cfg.use_grid or cfg.sdf_bounding_sphere <= 0.0:
        return sdf
    sphere_sdf = cfg.sphere_scale * (
        cfg.sdf_bounding_sphere - torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    )
    return torch.minimum(sdf, sphere_sdf)


def _net_input(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
               max_level: int | None = None) -> torch.Tensor:
    """The trunk's layer-0 input, plain path: PE(x), and in grid mode the
    grid features of x / divide_factor after it (only the first
    ``max_level`` levels, the rest zero)."""
    pe = positional_encoding(x, cfg.multires)
    if not cfg.use_grid:
        return pe
    if cfg.use_grid_feature:
        feature = hash_encode(params.encoding, cfg.grid, x / cfg.divide_factor, n_levels=max_level)
    else:
        feature = torch.zeros(*x.shape[:-1], cfg.grid_feature_dim, dtype=x.dtype, device=x.device)
    return torch.cat([pe, feature], dim=-1)


def sdf_value(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
              dtype=None, max_level: int | None = None) -> torch.Tensor:
    """x (..., 3) -> sdf (..., 1)."""
    out = implicit_apply(params, cfg, x, dtype=dtype, max_level=max_level)
    return _clamp_sdf(cfg, out[..., :1], x)


def sweep_weights(params: ImplicitNet, cfg: ImplicitNetConfig):
    """K1's weights for the sampler's sweeps: the effective (W, b) lists
    with the last layer cut to its SDF column, and their packed buffers
    (``kernels.sdf_mlp.pack``: float32, and bf16 in the tensor cores'
    layout). A render resolves them once for all of its sweeps."""
    ws, bs = effective_linear_weights(params)
    ws[-1], bs[-1] = ws[-1][:, :1], bs[-1][:1]
    return ws, bs, pack_sweep(ws, bs, tuple(cfg.skip_in))


def sdf_value_pallas(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                     dtype=None, pe_in_kernel: bool = False, weights=None) -> torch.Tensor:
    """The sampler sweeps' SDF through K1: the last layer is cut to its SDF
    column, the sphere clamp comes after. The embedding is computed here, or
    with ``pe_in_kernel`` inside the kernel from the raw points (K1-PE, as
    monosdf_tpu's ``sdf_value_pallas(pe_in_kernel=True)``). ``weights``:
    ``sweep_weights(params, cfg)``, resolved here if None."""
    ws, bs, packed = weights if weights is not None else sweep_weights(params, cfg)
    flat = x.reshape(-1, 3)
    if pe_in_kernel:
        out = sdf_mlp_pe(ws, bs, flat, cfg.multires, tuple(cfg.skip_in), dtype=dtype,
                         packed=packed)
    else:
        out = sdf_mlp(ws, bs, positional_encoding(flat, cfg.multires), tuple(cfg.skip_in),
                      dtype=dtype, packed=packed)
    return _clamp_sdf(cfg, out.reshape(*x.shape[:-1], 1), x)


def grid_table(params: ImplicitNet, cfg: ImplicitNetConfig):
    """The hash table the kernel path's encodes read (``ops.hashgrid.
    read_table``): one bf16 copy per render or step when the table is read
    at bf16. None outside grid mode."""
    return read_table(params.encoding, cfg.grid) if cfg.use_grid else None


def _grid_features(params, cfg: ImplicitNetConfig, x: torch.Tensor, table, n_levels=None,
                   tangents: bool = False):
    """Kernel path: the grid features of x (N, 3) through K6 (K6/K5 under
    grad with tangents), and with ``tangents`` their derivatives in x."""
    g = cfg.grid
    if not cfg.use_grid_feature:
        z = torch.zeros(x.shape[0], g.output_dim, dtype=x.dtype, device=x.device)
        return (z, torch.zeros(3, *z.shape, dtype=x.dtype, device=x.device)) if tangents else z
    xs = x / cfg.divide_factor
    if tangents:
        return encode_diff(params.encoding.embeddings, table, g, xs, 1.0, 1.0 / cfg.divide_factor)
    return hash_encode_fwd(table, g, xs.contiguous(), 1.0, n_levels)


def sdf_value_pallas_grid(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                          dtype=None, max_level: int | None = None, weights=None,
                          table=None) -> torch.Tensor:
    """Grid-mode sweeps: [PE | the first ``max_level`` levels' features
    (K6), zero-padded] through K1, last layer cut to the SDF column, no
    clamp. ``weights``: ``sweep_weights(params, cfg)``; ``table``:
    ``grid_table(params, cfg)``; each resolved here if None."""
    ws, bs, packed = weights if weights is not None else sweep_weights(params, cfg)
    table = grid_table(params, cfg) if table is None else table
    xf = x.reshape(-1, 3)
    inp = torch.cat([positional_encoding(xf, cfg.multires),
                     _grid_features(params, cfg, xf, table, max_level)], dim=-1)
    out = sdf_mlp(ws, bs, inp, tuple(cfg.skip_in), dtype=dtype, packed=packed)
    return out.reshape(*x.shape[:-1], 1)


def sdf_feat_grad_pallas_grid(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                              dtype=None, table=None):
    """Grid-mode sdf_feat_grad through K6 and K7: the layer-0 input [PE(x)
    | features] and its three spatial tangents (PE's in closed form, the
    features' from K6) go to K7f as one (4, N, d0) operand. Under grad it is
    differentiable: K7b gives the parameter gradients and the input
    cotangents, which reach the table through K5, the eikonal's
    second-order path included."""
    if any(s < cfg.num_layers - 1 for s in cfg.skip_in):
        raise NotImplementedError("the grid trunk kernels take no skip connections")
    prefix = x.shape[:-1]
    a0 = grid_trunk_input(params, cfg, x.reshape(-1, 3).detach(), table)
    ws, bs = effective_linear_weights(params)
    sdf, f, g = sdf_mlp_with_grad_in(ws, bs, a0, dtype)
    return sdf.reshape(*prefix, 1), f.reshape(*prefix, -1), g.reshape(*prefix, 3)


def grid_trunk_input(params: ImplicitNet, cfg: ImplicitNetConfig, xf: torch.Tensor, table=None):
    """The grid trunk's layer-0 input of points xf (N, 3): (4, N, d0), [PE(x)
    | features] and its three spatial tangents."""
    N = xf.shape[0]
    table = grid_table(params, cfg) if table is None else table
    emb, tang = pe_with_tangents(xf, cfg.multires)
    feat, tg = _grid_features(params, cfg, xf, table, tangents=True)
    return torch.cat([torch.cat([emb, feat], dim=-1)[None],
                      torch.cat([tang.reshape(3, N, -1), tg], dim=-1)], dim=0)


def _spatial_grad(y: torch.Tensor, x: torch.Tensor, keep_graph: bool) -> torch.Tensor:
    """d sum(y) / dx; with ``keep_graph`` the gradient keeps its own graph,
    so a loss on it (the eikonal term) differentiates it."""
    (grad,) = torch.autograd.grad(y.sum(), x, create_graph=keep_graph)
    return grad


def sdf_feat_grad(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor, dtype=None):
    """x (..., 3) -> (sdf (..., 1), features (..., F), grad_x sdf (..., 3)),
    the gradient of the clamped SDF by autograd (the JAX package uses forward
    mode; the values agree). Under grad (training) all three keep their
    graph to the parameters, the gradient's by double backward."""
    training = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = implicit_apply(params, cfg, xg, dtype=dtype)
        sdf = _clamp_sdf(cfg, out[..., :1], xg)
        grad = _spatial_grad(sdf, xg, training)
    if training:
        return sdf, out[..., 1:], grad
    return sdf.detach(), out[..., 1:].detach(), grad


def sdf_gradient(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """x (..., 3) -> grad_x sdf (..., 3) of the UNclamped SDF (the
    reference's gradient_sdf applies no sphere clamp), for the eikonal
    points of the plain path; keeps its graph under grad, as sdf_feat_grad."""
    training = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        grad = _spatial_grad(implicit_apply(params, cfg, xg, dtype=dtype)[..., :1], xg, training)
    return grad


def sdf_feat_grad_pallas(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                         dtype=None, clamp_rows: int = -1):
    """sdf_feat_grad through K2 (clamp in-kernel; rows at or after
    ``clamp_rows``, the folded eikonal batch, unclamped). Features come at
    the operand dtype (bf16 under mixed precision), as on the TPU. Under
    grad it is differentiable: K2b gives the parameter gradients."""
    prefix = x.shape[:-1]
    ws, bs = effective_linear_weights(params)
    sdf, feat, grad = sdf_mlp_with_grad(
        ws, bs, x.reshape(-1, 3).contiguous(), cfg.multires, tuple(cfg.skip_in), dtype,
        float(cfg.sdf_bounding_sphere), float(cfg.sphere_scale), clamp_rows,
    )
    return sdf.reshape(*prefix, 1), feat.reshape(*prefix, -1), grad.reshape(*prefix, 3)


def sdf_gradient_pallas(params: ImplicitNet, cfg: ImplicitNetConfig, x: torch.Tensor,
                        dtype=None) -> torch.Tensor:
    """sdf_gradient (UNclamped) through a K2 call of its own: the eikonal
    points' gradient when they do not fold into the main call
    (``MonoSDFConfig.fold_eikonal=False``). MLP mode only; under grad K2b
    gives the parameter gradients."""
    prefix = x.shape[:-1]
    ws, bs = effective_linear_weights(params)
    _, _, grad = sdf_mlp_with_grad(ws, bs, x.reshape(-1, 3).contiguous(), cfg.multires,
                                   tuple(cfg.skip_in), dtype)
    return grad.reshape(*prefix, 3)


# ---------------------------------------------------------------------------
# Rendering (radiance) network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenderingNetConfig:
    feature_vector_size: int = 256
    mode: str = "idr"  # 'idr' (x, view, n, feat) or 'nerf' (view, feat)
    d_in: int = 9
    d_out: int = 3
    dims: tuple = (256, 256)
    weight_norm: bool = True
    multires_view: int = 4
    per_image_code: bool = False
    if_hdr: bool = False
    spec: bool = False
    max_images: int = 1024
    code_dim: int = 32

    @property
    def layer_dims(self) -> tuple:
        d0 = self.d_in + self.feature_vector_size
        if self.multires_view > 0:
            d0 += pe_dim(self.multires_view, 3) - 3
        if self.per_image_code:
            d0 += self.code_dim
        return (d0, *self.dims, self.d_out)

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims)


class RenderingNet(nn.Module):
    """The radiance MLP: layers ``lin0 ..`` and, with per-image codes,
    ``embeddings`` (max_images, code_dim). With the specular head
    (``spec``) layer ``num_layers - 3`` takes 3 inputs fewer: the diffuse
    colour is split off before it."""

    def __init__(self, cfg: RenderingNetConfig, device=None):
        super().__init__()
        dims = cfg.layer_dims
        for l in range(cfg.num_layers - 1):
            d_in = dims[l] - 3 if cfg.spec and l == cfg.num_layers - 3 else dims[l]
            self.add_module(f"lin{l}", Linear(d_in, dims[l + 1], cfg.weight_norm, device))
        if cfg.per_image_code:
            self.embeddings = nn.Parameter(
                torch.empty(cfg.max_images, cfg.code_dim, device=device)
            )

    def layers(self):
        return [m for name, m in self._modules.items() if name.startswith("lin")]


def init_rendering_net(cfg: RenderingNetConfig, generator: torch.Generator, device=None):
    net = RenderingNet(cfg, device)
    for lin in net.layers():
        init_linear(lin, generator)
    if cfg.per_image_code:
        with torch.no_grad():
            codes = (torch.rand(cfg.max_images, cfg.code_dim, generator=generator) * 2 - 1) * 1e-4
            net.embeddings.copy_(codes)
    return net


def rendering_apply(params: RenderingNet, cfg: RenderingNetConfig, points, normals,
                    view_dirs, feature_vectors, image_code=None, dtype=None) -> dict:
    """Per-sample radiance over flat (N, .) inputs: ``rgb``, and with the
    specular head (``spec``, HDR) ``rgb_diff`` and ``rgb_spec`` too: the
    diffuse trunk's first 3 channels are the diffuse colour, the rest go
    on through the specular layers, every layer with its ReLU, and rgb is
    their sum (monosdf_tpu/models/fields.py:544-556)."""
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    if cfg.mode == "idr":
        h = torch.cat([points, view_dirs, normals, feature_vectors.float()], dim=-1)
    elif cfg.mode == "nerf":
        h = torch.cat([view_dirs, feature_vectors.float()], dim=-1)
    else:
        raise NotImplementedError(cfg.mode)
    if cfg.per_image_code:
        h = torch.cat([h, image_code], dim=-1)
    lins = params.layers()
    if cfg.spec:
        if not cfg.if_hdr:
            raise ValueError("the specular head is HDR only (rendering.if_hdr)")
        split = cfg.num_layers - 3
        for lin in lins[:split]:
            h = torch.relu(apply_linear(lin, h, dtype=dtype))
        color_diff, h = h[:, :3], h[:, 3:]
        for lin in lins[split:]:
            h = torch.relu(apply_linear(lin, h, dtype=dtype))
        return {"rgb": color_diff + h, "rgb_diff": color_diff, "rgb_spec": h}
    for l, lin in enumerate(lins):
        last = l == len(lins) - 1
        h = apply_linear(lin, h, dtype=dtype, keep_dtype=not last)
        if not last:
            h = torch.relu(h)
    h = torch.relu(h) if cfg.if_hdr else torch.sigmoid(h)
    return {"rgb": h.float()}


def rendering_apply_pallas(params: RenderingNet, cfg: RenderingNetConfig, points, normals,
                           view_dirs, feature_vectors, image_code=None, dtype=None) -> dict:
    """rendering_apply (no specular head: it runs the plain path, as in
    the JAX package) through the radiance kernels:
    in idr mode K8a (``kernels/radiance_split.py``) on the raw normals,
    [points | view PE], the features and the per-image code as separate
    operands; in nerf mode K8b (``kernels/radiance_mlp.py``) on h0 = [view
    PE | features | code]. view_dirs may come encoded already (per-ray PE
    repeated over samples). Under grad it is differentiable: the backward
    kernels give the parameter, normal, feature and code cotangents (none
    for the points and view directions)."""
    if cfg.multires_view > 0 and view_dirs.shape[-1] == 3:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    code = image_code if cfg.per_image_code else None
    if cfg.per_image_code and image_code is None:
        raise ValueError("per_image_code needs the image_code of every sample")
    ws, bs = effective_linear_weights(params)
    if cfg.mode == "idr":
        sv = torch.cat([points, view_dirs], dim=-1)
        out = radiance_split(ws, bs, normals, sv, feature_vectors, code, dtype)
    elif cfg.mode == "nerf":
        parts = [view_dirs, feature_vectors.float()] + ([code] if code is not None else [])
        out = mlp_with_input_grad(ws, bs, torch.cat(parts, dim=-1), dtype)
    else:
        raise NotImplementedError(cfg.mode)
    out = torch.relu(out) if cfg.if_hdr else torch.sigmoid(out)
    return {"rgb": out}


def rendering_apply_pallas_wide(params: RenderingNet, cfg: RenderingNetConfig, points, g,
                                view_dirs, feature_vectors, image_code=None,
                                dtype=None) -> dict:
    """Radiance through K3: takes the raw SDF gradient g (N, 3), normalises
    it in-kernel and returns rgb and the normals. view_dirs may come encoded
    already (per-ray PE repeated over samples); image_code (N, C) is the
    per-image code of every sample (``per_image_code``). Under grad it is
    differentiable: K3b gives the parameter, gradient, feature and code
    cotangents, with the normals' own cotangent summed in."""
    if cfg.mode != "idr":
        raise NotImplementedError("K3 covers the idr trunk")
    if cfg.per_image_code and image_code is None:
        raise ValueError("per_image_code needs the image_code of every sample")
    if cfg.multires_view > 0 and view_dirs.shape[-1] == 3:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    sv = torch.cat([points, view_dirs], dim=-1)
    code = image_code if cfg.per_image_code else None
    ws, bs = effective_linear_weights(params)
    out, normals = radiance_norm(ws, bs, g.contiguous(), sv, feature_vectors, dtype, code)
    out = torch.relu(out) if cfg.if_hdr else torch.sigmoid(out)
    return {"rgb": out, "normals": normals}

"""Top-level MonoSDF model (monosdf_tpu/models/monosdf.py).

Ray batch -> error-bounded sampling -> SDF, features and gradient ->
radiance -> volume rendering (``render_samples``: all after the sampling),
plus the eikonal points' gradients in training mode.
``render_rays(params, cfg, rays)`` takes the ``MonoSDF`` module as
``params``, as the JAX function takes the pytree.

Backends keep the JAX package's field names. ``'pallas'`` (and
``rgb_backend='fused'``) runs the kernel on a CUDA tensor and its plain
version on a CPU tensor; ``'jnp'`` runs the plain PyTorch path. With
per-image codes (``rendering.per_image_code``) the caller passes each ray's
``image_code`` (R, C), repeated here over the ray's samples.

Grid mode (``implicit.use_grid``): the sweeps read the first
``sweep_max_level`` grid levels only; every encode of one render or
training step reads one copy of the table at its ``table_dtype``
(``fields.grid_table``, the JAX package's ``with_table_cache``); in training
the eikonal points join the main points in one differentiated evaluation
(no clamp in grid mode, so nothing tells them apart), on both backends.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from ..ops.density import get_beta, laplace_density
from ..ops.embedder import positional_encoding
from ..ops.geometry import get_camera_params
from ..ops.render import render_ray_outputs, volume_rendering_weights
from ..ops.sampler import SamplerConfig, error_bound_z_vals
from .fields import (
    ImplicitNetConfig,
    RenderingNetConfig,
    grid_table,
    init_implicit_net,
    init_rendering_net,
    rendering_apply,
    rendering_apply_pallas,
    rendering_apply_pallas_wide,
    sdf_feat_grad,
    sdf_feat_grad_pallas,
    sdf_feat_grad_pallas_grid,
    sdf_gradient,
    sdf_value,
    sdf_value_pallas,
    sdf_value_pallas_grid,
    sweep_weights,
)


@dataclasses.dataclass(frozen=True)
class MonoSDFConfig:
    implicit: ImplicitNetConfig = ImplicitNetConfig()
    rendering: RenderingNetConfig = RenderingNetConfig()
    sampler: SamplerConfig = SamplerConfig()
    white_bkgd: bool = False
    bg_color: tuple = (1.0, 1.0, 1.0)
    beta_init: float = 0.1
    beta_min: float = 1e-4
    # dtype of the sampler sweeps (and, with mixed_precision, of the main
    # forward's matmul operands); parameters stay float32
    compute_dtype: str = "float32"
    mixed_precision: bool = False
    # grid mode: the sampler's sweeps read the first K grid levels only
    # (None: all of them)
    sweep_max_level: int | None = None
    # 'jnp' or 'pallas' (K1 on the (N, 39) embedding, or in grid mode on
    # [PE | K6 features]): the sampler's no-grad SDF sweeps
    sampler_backend: str = "jnp"
    # MLP mode, sampler_backend 'pallas': the sweeps take the raw points and
    # compute the positional encoding inside the kernel (K1-PE) instead of
    # reading the (N, 39) embedding (K1)
    sweep_pe_in_kernel: bool = False
    # 'jnp' or 'pallas' (K2; in grid mode K6/K5 and K7): SDF, features and
    # spatial gradient
    diff_backend: str = "jnp"
    # 'jnp'; 'fused' (K3 on the raw gradient, normalised in-kernel; needs
    # diff_backend='pallas' and MLP mode, else the plain path); or 'pallas'
    # (K8a on the raw gradient, idr mode, MLP and grid mode alike; the
    # normals for the loss are normalised outside)
    rgb_backend: str = "jnp"

    def __post_init__(self):
        for field, ok in (("sampler_backend", ("jnp", "pallas")),
                          ("diff_backend", ("jnp", "pallas")),
                          ("rgb_backend", ("jnp", "fused", "pallas"))):
            if getattr(self, field) not in ok:
                raise NotImplementedError(f"{field}={getattr(self, field)!r}; ported: {ok}")


class Density(nn.Module):
    def __init__(self, beta_init: float, device=None):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(beta_init, dtype=torch.float32, device=device))


class MonoSDF(nn.Module):
    """Parameters ``implicit.lin*`` (and in grid mode
    ``implicit.encoding.embeddings``), ``rendering.lin*``, ``density.beta``,
    named as the JAX pytree of ``init_monosdf``."""

    def __init__(self, implicit: nn.Module, rendering: nn.Module, density: Density):
        super().__init__()
        self.implicit, self.rendering, self.density = implicit, rendering, density


def init_monosdf(cfg: MonoSDFConfig, seed: int = 0, device=None) -> MonoSDF:
    """Initialised model on ``device`` (cuda unless ``device='cpu'``). The
    draws come from a ``torch.Generator`` seeded with ``seed``; they are not
    the JAX package's bits (``params.load_jax_params`` carries those over)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return MonoSDF(
        init_implicit_net(cfg.implicit, gen, dev),
        init_rendering_net(cfg.rendering, gen, dev),
        Density(cfg.beta_init, dev),
    )


def rays_from_camera(uv, pose, intrinsics) -> dict:
    """uv (B,N,2), pose (B,4,4), intrinsics (B,4,4) -> flat ray batch; the
    depth_scale is the z of the camera-frame ray direction."""
    ray_dirs, cam_loc = get_camera_params(uv, pose, intrinsics)
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device)[None].expand(pose.shape[0], 4, 4)
    ray_dirs_cam, _ = get_camera_params(uv, eye, intrinsics)
    B, N, _ = ray_dirs.shape
    return {
        "rays_o": cam_loc[:, None, :].expand(B, N, 3).reshape(-1, 3),
        "rays_d": ray_dirs.reshape(-1, 3),
        "depth_scale": ray_dirs_cam.reshape(-1, 3)[:, 2:],
        "pose": pose[:, None].expand(B, N, 4, 4).reshape(-1, 4, 4),
    }


def _dtype(name: str):
    return None if name == "float32" else getattr(torch, name)


def eikonal_points(rays_o, rays_d, z_eik, bound: float, draws=None, generator=None):
    """The eikonal points (4R, 3): R uniform in [-bound, bound)^3, R near the
    surface at z_eik along each ray, and a neighbour of each of those 2R
    within +-0.005 per axis. ``draws`` may hold ``eik_uniform`` (R, 3), the
    uniform points, and ``eik_neigh`` (2R, 3) in [0, 1), the neighbours'
    offsets; the rest come from ``generator``."""
    draws = draws or {}
    R = rays_o.shape[0]
    kw = {"generator": generator, "device": rays_o.device, "dtype": rays_o.dtype}
    uniform = draws.get("eik_uniform")
    if uniform is None:
        uniform = torch.rand(R, 3, **kw) * (2.0 * bound) - bound
    pts = torch.cat([uniform, rays_o + z_eik * rays_d], dim=0)
    neigh = draws.get("eik_neigh")
    if neigh is None:
        neigh = torch.rand(2 * R, 3, **kw)
    return torch.cat([pts, pts + (neigh - 0.5) * 0.01], dim=0)


@torch.no_grad()
def sample_rays(params: MonoSDF, cfg: MonoSDFConfig, rays: dict, training: bool = False,
                draws=None, generator=None, table=None):
    """The sampler half of ``render_rays``: z_vals (R, S) in eval; in
    training (z_vals, eikonal points (4R, 3)), drawn with ``draws`` and
    ``generator`` as ``render_rays`` says. ``table``: grid mode's read
    table (``fields.grid_table``), made here if None."""
    imp_cfg = cfg.implicit
    beta0 = get_beta(params.density.beta, cfg.beta_min)
    sampler_dtype = _dtype(cfg.compute_dtype)
    if cfg.sampler_backend == "pallas":
        # weight norm resolved and the weights packed once for all the sweeps
        weights = sweep_weights(params.implicit, imp_cfg)
        if imp_cfg.use_grid:
            table = grid_table(params.implicit, imp_cfg) if table is None else table

            def sampler_sdf(pts):
                return sdf_value_pallas_grid(params.implicit, imp_cfg, pts, sampler_dtype,
                                             cfg.sweep_max_level, weights, table)[..., 0]
        else:
            def sampler_sdf(pts):
                return sdf_value_pallas(params.implicit, imp_cfg, pts, sampler_dtype,
                                        cfg.sweep_pe_in_kernel, weights)[..., 0]
    else:
        def sampler_sdf(pts):
            return sdf_value(params.implicit, imp_cfg, pts, dtype=sampler_dtype,
                             max_level=cfg.sweep_max_level)[..., 0]

    sampled = error_bound_z_vals(sampler_sdf, rays["rays_o"], rays["rays_d"], beta0,
                                 cfg.sampler, training, draws, generator)
    if not training:
        return sampled
    z_vals, z_eik = sampled
    # the uniform eikonal points fill the sampler's scene box (the JAX
    # config's separate scene_bounding_sphere takes the same value)
    return z_vals, eikonal_points(rays["rays_o"], rays["rays_d"], z_eik,
                                  cfg.sampler.scene_bounding_sphere, draws, generator)


def render_rays(params: MonoSDF, cfg: MonoSDFConfig, rays: dict, training: bool = False,
                image_code=None, draws=None, generator=None) -> dict:
    """Render a flat ray batch: the error-bounded sampler (``sample_rays``),
    then ``render_samples`` at the points it drew.

    rays: rays_o (R,3), rays_d (R,3) normalised, depth_scale (R,1), pose
    (R,4,4) camera-to-world. Returns rgb, rgb_values, depth_values, z_vals,
    depth_vals, sdf, weights and normal_map (camera frame), and with the
    specular head (``rendering.spec``) rgb_spec (R, S, 3) and
    rgb_spec_values, its composite.

    Eval (``training=False``) runs without grad. Training draws the
    sampler's jitter, final draw, extra samples and eikonal pick and the
    eikonal points at random (``draws`` may hold any of them, see
    ``ops.sampler.training_draws`` and ``eikonal_points``; the rest come
    from ``generator``), keeps the graph to the parameters (call it under
    grad), and adds ``grad_theta`` and ``grad_theta_nei`` (2R, 3 each): the
    unclamped SDF gradient at the eikonal points and at their neighbours."""
    table = grid_table(params.implicit, cfg.implicit)  # one per call, shared by every encode
    if not training:
        return render_samples(params, cfg, rays, sample_rays(params, cfg, rays, table=table),
                              image_code, table=table)
    z_vals, eik = sample_rays(params, cfg, rays, True, draws, generator, table)
    return render_samples(params, cfg, rays, z_vals, image_code, eik_points=eik, table=table)


def render_samples(params: MonoSDF, cfg: MonoSDFConfig, rays: dict, z_vals: torch.Tensor,
                   image_code=None, eik_points=None, table=None) -> dict:
    """The render after the sampler: SDF, features and gradient at the
    points at ``z_vals`` (R, S) along each ray, radiance and volume
    rendering. Given the z_vals of another render, it renders at exactly
    those points. Returns what ``render_rays`` returns.

    Without ``eik_points`` it is the eval render, without grad. With them
    (training: (4R, 3), see ``eikonal_points``) it keeps the graph and adds
    ``grad_theta``/``grad_theta_nei``; on the K2 path the eikonal points go
    through the same K2 call as the main points, unclamped (``clamp_rows``:
    the JAX package's ``fold_eikonal=True``, its default and the bench's),
    so one K2f and one K2b launch serve both. In grid mode they join the
    main points on both backends. ``table``: grid mode's read table
    (``fields.grid_table``), made here if None."""
    if eik_points is None:
        with torch.no_grad():
            return _render_samples(params, cfg, rays, z_vals, image_code, None, table)
    return _render_samples(params, cfg, rays, z_vals, image_code, eik_points, table)


def radiance_route(cfg: MonoSDFConfig) -> str:
    """The radiance path of a render: 'fused' (K3, on K2's raw gradient),
    'split' (K8a) or 'plain'. The specular head and the other modes take
    the plain path on every backend, as in the JAX package
    (monosdf_tpu/models/monosdf.py:205-208, 317-320)."""
    ren = cfg.rendering
    if ren.mode != "idr" or ren.spec:
        return "plain"
    if cfg.rgb_backend == "fused" and cfg.diff_backend == "pallas" and not cfg.implicit.use_grid:
        return "fused"
    return "split" if cfg.rgb_backend == "pallas" else "plain"


def routed_kernels(cfg: MonoSDFConfig) -> tuple:
    """The kernels (``kernels.build.KERNELS`` names) that a training run of
    ``cfg`` launches on the card: its steps (``sample_rays`` and
    ``_render_samples``), its validation renders and its mesh export
    (``meshing.mesh_sdf_fn``, routed as the sweeps)."""
    grid = cfg.implicit.use_grid
    out = []
    if cfg.sampler_backend == "pallas":
        out += ["sdf_mlp", "hash_encode"] if grid else [
            "sdf_mlp_pe" if cfg.sweep_pe_in_kernel else "sdf_mlp"]
    if cfg.sampler.machinery == "pallas":
        out.append("sampler_machinery")
    if cfg.diff_backend == "pallas":
        out += (["hash_encode", "sdf_grad_grid", "sdf_grad_grid_bwd", "hash_encode_bwd"] if grid
                else ["sdf_grad", "sdf_grad_bwd"])
    out += {"fused": ["radiance_norm", "radiance_norm_bwd"],
            "split": ["radiance_split", "radiance_split_bwd"]}.get(radiance_route(cfg), [])
    return tuple(dict.fromkeys(out))


def _render_samples(params, cfg, rays, z_vals, image_code, eik_points, table) -> dict:
    rays_o, rays_d = rays["rays_o"], rays["rays_d"]
    R, S = z_vals.shape
    imp_cfg = cfg.implicit
    points_flat = (rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]).reshape(-1, 3)
    n_main = points_flat.shape[0]
    training = eik_points is not None

    main_dtype = _dtype(cfg.compute_dtype) if cfg.mixed_precision else None
    use_pallas_diff = cfg.diff_backend == "pallas" and not imp_cfg.use_grid
    if imp_cfg.use_grid:
        pts_in = torch.cat([points_flat, eik_points], dim=0) if training else points_flat
        if cfg.diff_backend == "pallas":
            table = grid_table(params.implicit, imp_cfg) if table is None else table
            sdf, feature_vectors, gradients = sdf_feat_grad_pallas_grid(
                params.implicit, imp_cfg, pts_in, dtype=main_dtype, table=table)
        else:
            sdf, feature_vectors, gradients = sdf_feat_grad(params.implicit, imp_cfg, pts_in,
                                                            dtype=main_dtype)
        if training:
            grad_theta = gradients[n_main:]
            sdf = sdf[:n_main]
            feature_vectors = feature_vectors[:n_main]
            gradients = gradients[:n_main]
    elif use_pallas_diff:
        pts_in = torch.cat([points_flat, eik_points], dim=0) if training else points_flat
        sdf, feature_vectors, gradients = sdf_feat_grad_pallas(
            params.implicit, imp_cfg, pts_in, dtype=main_dtype,
            clamp_rows=n_main if training else -1,
        )
        if training:
            grad_theta = gradients[n_main:]
            sdf = sdf[:n_main]
            feature_vectors = feature_vectors[:n_main]
            gradients = gradients[:n_main]
    else:
        sdf, feature_vectors, gradients = sdf_feat_grad(params.implicit, imp_cfg, points_flat,
                                                        dtype=main_dtype)
        if training:
            grad_theta = sdf_gradient(params.implicit, imp_cfg, eik_points, dtype=main_dtype)

    code_flat = None
    if image_code is not None:
        code_flat = image_code[:, None, :].expand(R, S, image_code.shape[-1]).reshape(R * S, -1)

    ren_cfg = cfg.rendering
    route = radiance_route(cfg)
    rgb_fused = route == "fused"
    if route != "plain":
        # view dirs are constant along a ray: encode (R, 3) once, repeat over samples
        dirs_in = rays_d[:, None, :].expand(R, S, 3).reshape(R * S, 3)
        if ren_cfg.multires_view > 0:
            pe = positional_encoding(rays_d, ren_cfg.multires_view)
            dirs_in = pe[:, None, :].expand(R, S, pe.shape[-1]).reshape(R * S, -1)
        apply = rendering_apply_pallas_wide if rgb_fused else rendering_apply_pallas
        render_out = apply(params.rendering, ren_cfg, points_flat, gradients, dirs_in,
                           feature_vectors, code_flat, dtype=main_dtype)
    else:
        dirs_flat = rays_d[:, None, :].expand(R, S, 3).reshape(R * S, 3)
        render_out = rendering_apply(
            params.rendering, ren_cfg, points_flat, gradients, dirs_flat, feature_vectors,
            code_flat, dtype=main_dtype,
        )
    if rgb_fused:
        normals = render_out["normals"].reshape(R, S, 3)
    else:
        grad_sq = torch.sum(gradients * gradients, dim=-1, keepdim=True)
        normals = gradients / (torch.sqrt(torch.clamp(grad_sq, min=1e-24)) + 1e-6)
        normals = normals.reshape(R, S, 3)
    rgb = render_out["rgb"].reshape(R, S, 3)

    beta = get_beta(params.density.beta, cfg.beta_min)
    density = laplace_density(sdf[..., 0].reshape(R, S), beta)
    weights = volume_rendering_weights(z_vals, density)
    rgb_values, depth_values, normal_map = render_ray_outputs(
        weights, z_vals, rgb, normals, rays["depth_scale"]
    )
    if cfg.white_bkgd:
        # the background colour as Python floats: a tensor made from them on
        # the card would be a host-to-device copy that waits for the stream
        rest = 1.0 - torch.sum(weights, dim=-1)
        rgb_values = rgb_values + torch.stack([rest * c for c in cfg.bg_color], dim=-1)

    # world normals into the camera frame
    rot = rays["pose"][:, :3, :3].transpose(1, 2)
    normal_map = torch.einsum("rij,rj->ri", rot, normal_map)
    out = {
        "rgb": rgb,
        "rgb_values": rgb_values,
        "depth_values": depth_values,
        "z_vals": z_vals,
        "depth_vals": z_vals * rays["depth_scale"],
        "sdf": sdf.reshape(R, S),
        "weights": weights,
        "normal_map": normal_map,
    }
    if ren_cfg.spec:
        rgb_spec = render_out["rgb_spec"].reshape(R, S, 3)
        out["rgb_spec"] = rgb_spec
        out["rgb_spec_values"] = torch.sum(weights[..., None] * rgb_spec, dim=1)
    if training:
        half = eik_points.shape[0] // 2
        out["grad_theta"], out["grad_theta_nei"] = grad_theta[:half], grad_theta[half:]
    return out

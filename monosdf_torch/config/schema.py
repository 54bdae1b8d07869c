"""Map reference-style HOCON conf trees onto the port's typed configs
(monosdf_tpu/config/schema.py ``build_configs``, field for field).

Key names follow the reference conf schema (e.g. code/confs/mp.conf). The
``tpu{}`` block keeps its name and its fields: ``compute_dtype``,
``mixed_precision``, the backends ``sampler_backend``, ``diff_backend``,
``rgb_backend`` and ``sampler_machinery``, ``sweep_max_level``, and
``sweep_pe_in_kernel`` (the sweeps through K1-PE). The table knobs that
only choose TPU layouts (``hash_layout``, ``scatter_impl``,
``gather_chunks``, ``param_flat``'s layout and ``tpu.sweep_oct``) are
accepted and change no value (``ops/hashgrid.py``); ``sweep_oct`` keeps the
JAX schema's checks, so a conf that the JAX package refuses is refused here
too. ``param_flat`` keeps its shape: the table parameter is one (T*C,)
vector, as in the JAX package's checkpoints.

Kernel routing. On the card, wherever the JAX package reaches a Pallas
kernel under a conf, the port reaches that kernel's counterpart under the
same conf. The backends map one to one, with one rule more: a grid model
whose conf asks for the Pallas table build or fold (``build_impl`` or
``fold_impl = pallas``, JAX's K6 and K5) takes the port's kernel grid path
(``sampler_backend = diff_backend = 'pallas'``): K6 and K1 for the sweeps,
K6, K7f, K7b and K5 for the differentiated forward. The port's K6 and K5
run only on that path. ``routed_kernels`` (``models.monosdf``, where the
render takes its routes) names the kernels a model's training run launches.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..losses import LossConfig
from ..models.fields import ImplicitNetConfig, RenderingNetConfig
from ..models.monosdf import MonoSDFConfig
from ..ops.hashgrid import HashGridConfig
from ..ops.sampler import SamplerConfig
from ..train.optim import OptimConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    expname: str
    model: MonoSDFConfig
    loss: LossConfig
    optim: OptimConfig
    num_pixels: int = 1024
    split_n_pixels: int = 1024
    max_total_iters: int = 150_000
    checkpoint_freq: int = 50
    plot_freq: int = 50
    plot_resolution: int = 512
    grid_boundary: tuple = (-1.1, 1.1)
    plot_nimgs: int = 1
    dataset: dict = dataclasses.field(default_factory=dict)
    raw: dict = dataclasses.field(default_factory=dict)


_RGB_LOSS_MAP = {
    "torch.nn.L1Loss": "l1",
    "torch.nn.MSELoss": "mse",
    "l1": "l1",
    "mse": "mse",
}


def _get(d: dict, key: str, default: Any = None):
    return d.get(key, default)


def build_configs(conf: dict) -> ExperimentConfig:
    train = conf.get("train", {})
    model = conf.get("model", {})
    loss = conf.get("loss", {})
    dataset = conf.get("dataset", {})
    plot = conf.get("plot", {})
    tpu = conf.get("tpu", {})

    grid_mlp = bool(_get(model, "Grid_MLP", False))
    white_bkgd = bool(_get(model, "white_bkgd", False))
    scene_r = float(_get(model, "scene_bounding_sphere", 1.0))
    feat = int(_get(model, "feature_vector_size", 256))
    if_hdr = bool(_get(dataset, "if_hdr", False))
    if_gt_data = bool(_get(dataset, "if_gt_data", False))

    imp = model.get("implicit_network", {})
    grid_cfg = HashGridConfig(
        num_levels=int(_get(imp, "num_levels", 16)),
        level_dim=int(_get(imp, "level_dim", 2)),
        base_resolution=int(_get(imp, "base_size", 16)),
        log2_hashmap_size=int(_get(imp, "logmap", 19)),
        desired_resolution=int(_get(imp, "end_size", 2048)),
        table_dtype=str(_get(imp, "table_dtype", "bfloat16")),
        scatter_impl=str(_get(imp, "scatter_impl", "flat")),
        hash_scheme=str(_get(imp, "hash_scheme", "xor")),
        layout=str(_get(imp, "hash_layout", "rows")),
        fold_impl=str(_get(imp, "fold_impl", "xla")),
        build_impl=str(_get(imp, "build_impl", "xla")),
        param_flat=bool(_get(imp, "param_flat", False)),
        gather_chunks=int(_get(imp, "gather_chunks", 1)),
    )
    implicit = ImplicitNetConfig(
        feature_vector_size=feat,
        sdf_bounding_sphere=0.0 if white_bkgd else scene_r,
        d_in=int(_get(imp, "d_in", 3)),
        d_out=int(_get(imp, "d_out", 1)),
        dims=tuple(_get(imp, "dims", [256, 256])),
        geometric_init=bool(_get(imp, "geometric_init", True)),
        bias=float(_get(imp, "bias", 1.0)),
        skip_in=tuple(_get(imp, "skip_in", [])),
        weight_norm=bool(_get(imp, "weight_norm", True)),
        multires=int(_get(imp, "multires", 0)),
        sphere_scale=float(_get(imp, "sphere_scale", 1.0)),
        inside_outside=bool(_get(imp, "inside_outside", False)),
        use_grid=grid_mlp,
        use_grid_feature=bool(_get(imp, "use_grid_feature", True)),
        divide_factor=float(_get(imp, "divide_factor", 1.5)),
        grid=grid_cfg,
    )

    ren = model.get("rendering_network", {})
    rendering = RenderingNetConfig(
        feature_vector_size=feat,
        mode=str(_get(ren, "mode", "idr")),
        d_in=int(_get(ren, "d_in", 9)),
        d_out=int(_get(ren, "d_out", 3)),
        dims=tuple(_get(ren, "dims", [256, 256])),
        weight_norm=bool(_get(ren, "weight_norm", True)),
        multires_view=int(_get(ren, "multires_view", 0)),
        per_image_code=bool(_get(ren, "per_image_code", False)),
        if_hdr=if_hdr,
        spec=bool(_get(ren, "spec", False)),
    )

    rs = model.get("ray_sampler", {})
    sampler = SamplerConfig(
        scene_bounding_sphere=scene_r,
        near=float(_get(rs, "near", 0.0)),
        far=float(_get(rs, "far", -1.0)),
        N_samples=int(_get(rs, "N_samples", 64)),
        N_samples_eval=int(_get(rs, "N_samples_eval", 128)),
        N_samples_extra=int(_get(rs, "N_samples_extra", 32)),
        eps=float(_get(rs, "eps", 0.1)),
        beta_iters=int(_get(rs, "beta_iters", 10)),
        max_total_iters=int(_get(rs, "max_total_iters", 5)),
        intersection=str(_get(rs, "intersection", "cube")),
        machinery=str(_get(tpu, "sampler_machinery", "jnp")),
    )

    den = model.get("density", {})
    sweep_max = int(_get(tpu, "sweep_max_level", 0)) or None
    if bool(_get(tpu, "sweep_oct", False)):
        # the JAX package's per-step oct cache of the coarse sweeps: the same
        # values, so here only its prerequisites are checked
        if not sweep_max:
            raise ValueError(
                "tpu.sweep_oct requires tpu.sweep_max_level > 0 (the oct "
                "cache serves the coarse-level sampler sweeps)"
            )
        if implicit.grid.layout != "quad" or implicit.grid.scatter_impl != "fold":
            raise ValueError(
                "tpu.sweep_oct requires the quad+fold encoding "
                f"(got layout={implicit.grid.layout!r}, "
                f"scatter_impl={implicit.grid.scatter_impl!r}); see "
                "HashGridConfig.sweep_oct_levels"
            )
        implicit = dataclasses.replace(
            implicit, grid=dataclasses.replace(implicit.grid, sweep_oct_levels=sweep_max))
    sampler_backend = str(_get(tpu, "sampler_backend", "jnp"))
    diff_backend = str(_get(tpu, "diff_backend", "jnp"))
    if grid_mlp and "pallas" in (grid_cfg.build_impl, grid_cfg.fold_impl):
        # the kernel routing rule (module docstring): JAX's K6/K5 run on the
        # port's kernel grid path only
        sampler_backend = diff_backend = "pallas"
    model_cfg = MonoSDFConfig(
        implicit=implicit,
        rendering=rendering,
        sampler=sampler,
        white_bkgd=white_bkgd,
        bg_color=tuple(_get(model, "bg_color", [1.0, 1.0, 1.0])),
        beta_init=float(_get(den.get("params_init", {}), "beta", 0.1)),
        beta_min=float(_get(den, "beta_min", 1e-4)),
        compute_dtype=str(_get(tpu, "compute_dtype", "float32")),
        mixed_precision=bool(_get(tpu, "mixed_precision", False)),
        sampler_backend=sampler_backend,
        diff_backend=diff_backend,
        rgb_backend=str(_get(tpu, "rgb_backend", "jnp")),
        sweep_max_level=sweep_max,
        sweep_pe_in_kernel=bool(_get(tpu, "sweep_pe_in_kernel", False)),
    )

    max_total_iters = int(_get(train, "max_total_iters", 150_000))
    loss_cfg = LossConfig(
        rgb_loss=_RGB_LOSS_MAP.get(str(_get(loss, "rgb_loss", "l1")), "l1"),
        eikonal_weight=float(_get(loss, "eikonal_weight", 0.05)),
        smooth_weight=float(_get(loss, "smooth_weight", 0.005)),
        depth_weight=float(_get(loss, "depth_weight", 0.1)),
        normal_l1_weight=float(_get(loss, "normal_l1_weight", 0.05)),
        normal_cos_weight=float(_get(loss, "normal_cos_weight", 0.05)),
        if_gamma_loss=bool(_get(loss, "if_gamma_loss", False)),
        # the reference passes if_scale_invariant_depth = not if_gt_data
        # (monosdf_train.py:206)
        if_scale_invariant_depth=not if_gt_data,
        end_step=int(_get(loss, "end_step", -1)),
    )

    optim_cfg = OptimConfig(
        learning_rate=float(_get(train, "learning_rate", 5e-4)),
        lr_factor_for_grid=float(_get(train, "lr_factor_for_grid", 1.0)),
        sched_decay_rate=float(_get(train, "sched_decay_rate", 0.1)),
        decay_steps=max_total_iters,
        grid_mode=grid_mlp,
    )

    return ExperimentConfig(
        expname=str(_get(train, "expname", "exp")),
        model=model_cfg,
        loss=loss_cfg,
        optim=optim_cfg,
        num_pixels=int(_get(train, "num_pixels", 1024)),
        split_n_pixels=int(_get(train, "split_n_pixels", 1024)),
        max_total_iters=max_total_iters,
        checkpoint_freq=int(_get(train, "checkpoint_freq", 100)),
        plot_freq=int(_get(train, "plot_freq", 50)),
        plot_resolution=int(_get(plot, "resolution", 512)),
        grid_boundary=tuple(_get(plot, "grid_boundary", [-1.1, 1.1])),
        plot_nimgs=int(_get(plot, "plot_nimgs", 1)),
        dataset=dataset,
        raw=conf,
    )


def load_conf(path: str, conf_add: str | None = None) -> dict:
    """The conf tree of ``path``, with the overlay ``conf_add`` merged in
    (the CLIs' --conf / --conf_add)."""
    from .hocon import merge_configs, parse_hocon_file

    conf = parse_hocon_file(path)
    return merge_configs(conf, parse_hocon_file(conf_add)) if conf_add else conf

"""The training step: render -> loss -> backward -> Adam
(monosdf_tpu/train/step.py ``make_train_step``)."""

from __future__ import annotations

import math

import torch

from ..losses import LossConfig, monosdf_loss
from ..models.monosdf import MonoSDF, MonoSDFConfig, render_rays
from .optim import Optimizer


def step_losses(model: MonoSDF, cfg: MonoSDFConfig, loss_cfg: LossConfig, batch: dict,
                step: int, draws=None, generator=None) -> dict:
    """The loss terms of one batch (``monosdf_loss`` at the schedule's
    ``step``), ``loss`` with its graph to the parameters, and ``psnr`` of the
    rendered rgb (no graph). With per-image codes each ray's code is its
    frame's row of ``rendering.embeddings``."""
    image_code = None
    if cfg.rendering.per_image_code:
        image_code = model.rendering.embeddings[batch["indices"]]
    out = render_rays(model, cfg, batch["rays"], training=True, image_code=image_code,
                      draws=draws, generator=generator)
    losses = monosdf_loss(loss_cfg, out, batch["gt"], step=step)
    with torch.no_grad():
        mse = torch.mean((out["rgb_values"] - batch["gt"]["rgb"]) ** 2)
        losses["psnr"] = -10.0 * torch.log(mse) / math.log(10.0)
    return losses


def updated_beta(model: MonoSDF, cfg: MonoSDFConfig) -> torch.Tensor:
    """|beta| + beta_min of the parameters as they stand (after the update)."""
    with torch.no_grad():
        return torch.abs(model.density.beta) + cfg.beta_min


def make_train_step(cfg: MonoSDFConfig, loss_cfg: LossConfig, optimizer: Optimizer):
    """Returns ``train_step(model, batch, draws=None, generator=None) ->
    metrics``.

    batch: {'rays': {rays_o, rays_d, depth_scale, pose}, 'gt': {rgb, depth,
    normal, mask}} on the model's device, and with per-image codes
    (``rendering.per_image_code``) 'indices' (R,), each ray's frame: the
    ray's code is that row of ``rendering.embeddings``. One step renders the batch in
    training mode (``draws``/``generator``: the random draws, see
    ``render_rays``), takes ``monosdf_loss`` at the optimizer's step count,
    back-propagates, and steps Adam and its schedule. metrics: the loss
    terms, ``psnr`` of the rendered rgb and the updated ``beta`` (|beta| +
    beta_min), as 0-d tensors not yet synchronised with the host."""
    adam, schedule = optimizer

    def train_step(model: MonoSDF, batch: dict, draws=None, generator=None) -> dict:
        adam.zero_grad(set_to_none=True)
        losses = step_losses(model, cfg, loss_cfg, batch, schedule.last_epoch, draws, generator)
        losses["loss"].backward()
        adam.step()
        schedule.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["beta"] = updated_beta(model, cfg)
        return metrics

    return train_step

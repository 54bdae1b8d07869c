"""The training step: render -> loss -> backward -> Adam
(monosdf_tpu/train/step.py ``make_train_step``)."""

from __future__ import annotations

import math

import torch

from ..losses import LossConfig, monosdf_loss
from ..models.monosdf import MonoSDF, MonoSDFConfig, render_rays
from .optim import Optimizer


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
        image_code = None
        if cfg.rendering.per_image_code:
            image_code = model.rendering.embeddings[batch["indices"]]
        out = render_rays(model, cfg, batch["rays"], training=True, image_code=image_code,
                          draws=draws, generator=generator)
        losses = monosdf_loss(loss_cfg, out, batch["gt"], step=schedule.last_epoch)
        losses["loss"].backward()
        adam.step()
        schedule.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        with torch.no_grad():
            mse = torch.mean((out["rgb_values"] - batch["gt"]["rgb"]) ** 2)
            metrics["psnr"] = -10.0 * torch.log(mse) / math.log(10.0)
            metrics["beta"] = torch.abs(model.density.beta) + cfg.beta_min
        return metrics

    return train_step

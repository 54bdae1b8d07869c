"""MonoSDF loss stack (monosdf_tpu/losses.py; reference loss.py:180-311).

Pixel-batch mode: rgb (L1 or MSE, optionally through the sRGB gamma),
eikonal and smoothness on the eikonal points' gradients, the
scale/shift-invariant depth loss and the normal L1 + cosine terms on the
foreground rays (GT mask and a sign change of the SDF along the ray), with
an optional exponential decay of the monocular cues.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .ops.scale_shift import compute_scale_and_shift_1d


@dataclasses.dataclass(frozen=True)
class LossConfig:
    rgb_loss: str = "l1"  # 'l1' | 'mse'
    eikonal_weight: float = 0.05
    smooth_weight: float = 0.005
    depth_weight: float = 0.1
    normal_l1_weight: float = 0.05
    normal_cos_weight: float = 0.05
    if_gamma_loss: bool = False
    if_scale_invariant_depth: bool = True
    end_step: int = -1  # > 0 enables exp(-10*step/end_step) cue decay


def srgb_gamma(x: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB gamma curve (reference loss.py:209-215)."""
    x_safe = torch.clamp(x, min=1e-8)
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * torch.pow(x_safe, 1.0 / 2.4) - 0.055)


def _safe_norm(v, dim=-1, keepdim=True, eps=1e-24):
    """Norm with a finite gradient at v = 0 (masked normal rows are exactly
    zero)."""
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=dim, keepdim=keepdim), min=eps))


def _normalize(v, eps=1e-12):
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return v / torch.clamp(_safe_norm(v), min=eps)


def rgb_loss_fn(rgb_values, rgb_gt, kind: str):
    diff = rgb_values - rgb_gt.reshape(-1, 3)
    if kind == "l1":
        return torch.mean(torch.abs(diff))
    return torch.mean(diff**2)


def eikonal_loss_fn(grad_theta):
    """mean((|grad| - 1)^2)."""
    return torch.mean((_safe_norm(grad_theta, keepdim=False) - 1.0) ** 2)


def smooth_loss_fn(grad_theta, grad_theta_nei):
    """Unisurf-style normal smoothness."""
    n1 = grad_theta / (_safe_norm(grad_theta) + 1e-5)
    n2 = grad_theta_nei / (_safe_norm(grad_theta_nei) + 1e-5)
    return torch.mean(_safe_norm(n1 - n2, keepdim=False))


def depth_loss_fn(depth_pred, depth_gt, mask, scale_invariant: bool):
    """Scale/shift-invariant masked MSE over the ray batch; the monocular cue
    is scaled by the reference's ``*50 + 0.5``."""
    pred = depth_pred.reshape(1, -1)
    mask = mask.reshape(1, -1).to(pred.dtype)
    if scale_invariant:
        target = (depth_gt * 50.0 + 0.5).reshape(1, -1)
        scale, shift = compute_scale_and_shift_1d(pred, target, mask)
        pred_ssi = scale.reshape(1, -1) * pred + shift.reshape(1, -1)
    else:
        target = depth_gt.reshape(1, -1)
        pred_ssi = pred
    M = torch.sum(mask, dim=1)
    res = pred_ssi - target
    image_loss = torch.sum(mask * res * res, dim=1)
    divisor = torch.sum(2.0 * M)
    return torch.where(divisor == 0, torch.zeros_like(divisor),
                       torch.sum(image_loss) / torch.clamp(divisor, min=1.0))


def normal_loss_fn(normal_pred, normal_gt):
    """L1 + cosine on normalised normals. The caller multiplies normal_pred
    by the mask, which zeroes the gradients of masked rays."""
    normal_gt = _normalize(normal_gt)
    normal_pred = _normalize(normal_pred)
    l1 = torch.mean(torch.sum(torch.abs(normal_pred - normal_gt), dim=-1))
    cos = torch.mean(1.0 - torch.sum(normal_pred * normal_gt, dim=-1))
    return l1, cos


def monosdf_loss(cfg: LossConfig, model_outputs: dict, ground_truth: dict, step=0) -> dict:
    """The full training loss and its terms (0-d tensors).

    ground_truth: rgb (R, 3), depth (R, 1), normal (R, 3), mask (R, 1)."""
    rgb_gt = ground_truth["rgb"]
    depth_pred = model_outputs["depth_values"]
    normal_pred = model_outputs["normal_map"]
    zero = depth_pred.new_zeros(())

    if cfg.if_gamma_loss:
        rgb_loss = rgb_loss_fn(srgb_gamma(model_outputs["rgb_values"]), srgb_gamma(rgb_gt),
                               cfg.rgb_loss)
    else:
        rgb_loss = rgb_loss_fn(model_outputs["rgb_values"], rgb_gt, cfg.rgb_loss)

    if "grad_theta" in model_outputs:
        eikonal_loss = eikonal_loss_fn(model_outputs["grad_theta"])
        smooth_loss = smooth_loss_fn(model_outputs["grad_theta"], model_outputs["grad_theta_nei"])
    else:
        eikonal_loss = smooth_loss = zero

    # foreground: GT mask and the ray crosses the surface (the SDF changes
    # sign along its samples)
    sdf = model_outputs["sdf"]
    crosses = torch.any(sdf > 0.0, dim=-1) & torch.any(sdf < 0.0, dim=-1)
    mask = (ground_truth["mask"].reshape(-1) > 0.5) & crosses
    mask_f = mask.to(depth_pred.dtype)

    depth_loss = depth_loss_fn(depth_pred, ground_truth["depth"], mask_f,
                               cfg.if_scale_invariant_depth)
    normal_l1, normal_cos = normal_loss_fn(normal_pred * mask_f[:, None],
                                           ground_truth["normal"].reshape(-1, 3))

    if cfg.end_step > 0:
        decay = math.exp(-10.0 * float(step) / cfg.end_step)
    else:
        decay = 1.0

    loss = (
        rgb_loss
        + cfg.eikonal_weight * eikonal_loss
        + cfg.smooth_weight * smooth_loss
        + decay * cfg.depth_weight * depth_loss
        + decay * cfg.normal_l1_weight * normal_l1
        + decay * cfg.normal_cos_weight * normal_cos
    )
    return {
        "loss": loss,
        "rgb_loss": rgb_loss,
        "eikonal_loss": eikonal_loss,
        "smooth_loss": smooth_loss,
        "depth_loss": depth_loss,
        "normal_l1": normal_l1,
        "normal_cos": normal_cos,
    }

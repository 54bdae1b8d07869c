"""Closed-form scale/shift least-squares solve, MiDaS-style
(monosdf_tpu/ops/scale_shift.py, the 1-D form the pixel-batch loss uses).

Solves min_{s,t} sum mask*(s*pred + t - target)^2 by the 2x2 normal
equations.
"""

from __future__ import annotations

import torch


def compute_scale_and_shift_1d(prediction, target, mask):
    """prediction/target/mask: (B, N). Returns scale (B,), shift (B,); both
    0 where the system is singular."""
    a_00 = torch.sum(mask * prediction * prediction, dim=1)
    a_01 = torch.sum(mask * prediction, dim=1)
    a_11 = torch.sum(mask, dim=1)
    b_0 = torch.sum(mask * prediction * target, dim=1)
    b_1 = torch.sum(mask * target, dim=1)
    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det, zero)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det, zero)
    return x_0, x_1

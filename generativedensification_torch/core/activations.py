"""Activation functions and the pipeline's calibrated output shifts.

Port of ``generativedensification_tpu/core/activations.py``:
  * opacity head shift: ``-2.1792`` (sigmoid(x - 2.1792) ≈ 0.1 at x=0),
  * coarse scale shift: ``log(0.5 * voxel_size / 3)``,
  * fine scale shift:   ``log(0.5 * voxel_size / (8 * 3))``.
"""

from __future__ import annotations

import math

import torch


class _TruncExp(torch.autograd.Function):
    """exp with a clamped backward: d/dx = exp(clip(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def inverse_sigmoid(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    y = y.clamp(eps, 1.0 - eps)
    return torch.log(y) - torch.log1p(-y)


def opacity_shift() -> float:
    return -2.1792


def coarse_scale_shift(voxel_size: float) -> float:
    return math.log(0.5 * voxel_size / 3.0)


def fine_scale_shift(voxel_size: float) -> float:
    return math.log(0.5 * voxel_size / (8.0 * 3.0))

"""Quaternion / rotation / covariance helpers for 3D Gaussians, PyTorch.

Port of ``generativedensification_tpu/core/transforms.py``.  Conventions:
  * quaternions are (w, x, y, z) ("real part first"),
  * 3D covariance Σ = R S Sᵀ Rᵀ with S = diag(scales),
  * the rasterizer consumes activated values: scales = exp(raw),
    opacity = sigmoid(raw), rotation = L2-normalized raw quaternion.
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (assumed normalized) -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): (..., 3, 3)."""
    return quat_to_rotmat(normalize_quat(quats)) * scales[..., None, :]


def build_covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Σ = L Lᵀ with L = R diag(s); symmetric PSD (..., 3, 3)."""
    L = build_scaling_rotation(scales, quats)
    return L @ L.transpose(-1, -2)


def covariance_to_symm6(cov: torch.Tensor) -> torch.Tensor:
    """Pack symmetric (..., 3, 3) into the 3DGS 6-vector (xx,xy,xz,yy,yz,zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )

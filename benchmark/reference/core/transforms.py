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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) wxyz quaternion (branch-free).

    The four-hypothesis construction: each candidate is the quaternion
    scaled by one of its components, and the one whose squared norm
    (1 + trace, 1 + 2·R_ii − trace) is largest is the best conditioned."""
    m = R
    diag = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
    t = diag.sum(-1)
    q0 = torch.stack([1.0 + t, m[..., 2, 1] - m[..., 1, 2],
                      m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    q1 = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                      1.0 + diag[..., 0] - diag[..., 1] - diag[..., 2],
                      m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], dim=-1)
    q2 = torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                      1.0 + diag[..., 1] - diag[..., 0] - diag[..., 2],
                      m[..., 1, 2] + m[..., 2, 1]], dim=-1)
    q3 = torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                      m[..., 1, 2] + m[..., 2, 1],
                      1.0 + diag[..., 2] - diag[..., 0] - diag[..., 1]], dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)                 # (..., 4, 4)
    norms2 = torch.stack([1.0 + t, 1.0 + 2 * diag[..., 0] - t,
                          1.0 + 2 * diag[..., 1] - t, 1.0 + 2 * diag[..., 2] - t], dim=-1)
    best = torch.argmax(norms2, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return normalize_quat(torch.gather(cands, -2, idx)[..., 0, :])

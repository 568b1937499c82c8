"""Ray construction and Plücker coordinates, PyTorch.

Port of ``generativedensification_tpu/core/rays.py``: pixel centers at
``(x + 0.5, y + 0.5, 1)`` back-projected through ``K^-1`` and rotated to
world by ``c2w[:3,:3]``; directions are not normalized.
"""

from __future__ import annotations

import torch


def camera_rays(cam) -> torch.Tensor:
    """Per-pixel rays (H, W, 6) = [origin, direction] from a ``Camera``."""
    H, W = cam.height, cam.width
    dev = cam.world_view_transform.device
    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 - W / 2.0) / cam.focal_x
    y = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5 - H / 2.0) / cam.focal_y
    Y, X = torch.meshgrid(y, x, indexing="ij")
    d_cam = torch.stack([X, Y, torch.ones_like(X)], dim=-1)      # (H, W, 3)
    R_c2w = cam.world_view_transform[:3, :3]   # w2c.T upper block = R_c2w
    dirs = torch.einsum("hwc,dc->hwd", d_cam, R_c2w)
    origins = (-cam.camera_center).expand(dirs.shape)
    return torch.cat([origins, dirs], dim=-1)


def rays_to_plucker(rays: torch.Tensor) -> torch.Tensor:
    """Rays (..., 6) -> Plücker coordinates (..., 6) = [d̂, o × d̂]."""
    o, d = rays[..., :3], rays[..., 3:6]
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-8)
    m = torch.linalg.cross(o, d, dim=-1)
    return torch.cat([d, m], dim=-1)

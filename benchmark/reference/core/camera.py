"""Camera model (pinhole, 3DGS rasterization convention), PyTorch.

Port of ``generativedensification_tpu/core/camera.py``.  The rasterizer
consumes *transposed* (row-vector) matrices ``world_view_transform = w2c.T``
and ``full_proj_transform = w2c.T @ P.T``; the camera center keeps the
dataset alignment convention ``camera_center = -c2w[:3, 3]``.
"""

from __future__ import annotations

import dataclasses

import torch


def rigid_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid [R t; 0 1] transform."""
    R = mat[..., :3, :3]
    t = mat[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t[..., None])], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mat.dtype, device=mat.device)
    bottom = bottom.expand(*mat.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def get_projection_matrix(znear, zfar, fovx, fovy) -> torch.Tensor:
    """OpenGL-style perspective projection (column-vector convention):
    ``P[0,0] = 1/tan(fovx/2)``, ``P[3,2] = +1``, z mapped to
    ``[0, zfar/(zfar-znear)]`` before the w-divide."""
    znear, zfar, fovx, fovy = torch.broadcast_tensors(znear, zfar, fovx, fovy)
    zero = torch.zeros_like(znear)
    one = torch.ones_like(znear)
    p00 = 1.0 / torch.tan(fovx / 2)
    p11 = 1.0 / torch.tan(fovy / 2)
    p22 = zfar / (zfar - znear)
    p23 = -(zfar * znear) / (zfar - znear)
    rows = [
        [p00, zero, zero, zero],
        [zero, p11, zero, zero],
        [zero, zero, p22, p23],
        [zero, zero, one, zero],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@dataclasses.dataclass
class Camera:
    """A render camera; tensor fields may carry leading batch dims."""

    world_view_transform: torch.Tensor  # (..., 4, 4) = w2c.T (row-vector)
    full_proj_transform: torch.Tensor   # (..., 4, 4) = w2c.T @ P.T
    camera_center: torch.Tensor         # (..., 3)
    tan_half_fovx: torch.Tensor         # (...)
    tan_half_fovy: torch.Tensor         # (...)
    znear: torch.Tensor                 # (...)
    zfar: torch.Tensor                  # (...)
    height: int = 512
    width: int = 512

    @classmethod
    def from_c2w(cls, c2w: torch.Tensor, fovx, fovy, width: int, height: int,
                 znear=0.1, zfar=100.0) -> "Camera":
        """Build from a camera-to-world pose (NeRF convention, aligned
        frame)."""
        c2w = c2w.to(torch.float32)
        batch = c2w.shape[:-2]
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=c2w.device)
        fovx = f32(fovx).expand(batch)
        fovy = f32(fovy).expand(batch)
        znear = f32(znear)
        zfar = f32(zfar)
        wvt = rigid_inverse(c2w).transpose(-1, -2)
        proj = get_projection_matrix(znear, zfar, fovx, fovy)
        return cls(
            world_view_transform=wvt,
            full_proj_transform=wvt @ proj.transpose(-1, -2),
            camera_center=-c2w[..., :3, 3],
            tan_half_fovx=torch.tan(fovx / 2),
            tan_half_fovy=torch.tan(fovy / 2),
            znear=znear * torch.ones_like(fovx),
            zfar=zfar * torch.ones_like(fovx),
            height=int(height),
            width=int(width),
        )

    def __getitem__(self, idx) -> "Camera":
        """Index the leading batch dims of every tensor field."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name)[idx]
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_half_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_half_fovy)

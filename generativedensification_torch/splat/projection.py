"""Per-Gaussian view-space preprocessing (the EWA projection stage).

Port of ``generativedensification_tpu/splat/projection.py``: view transform
-> perspective Jacobian -> 2D covariance (+0.3 px low-pass) -> conic +
screen radius.  Matrices are row-vector form (``p_view = [p,1] @ w2c.T``),
pixel centers via ndc2Pix ``((ndc + 1) * S - 1) / 2``, activations applied
by the caller.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sh import eval_sh_color

# 3DGS constants
NEAR_CULL = 0.2          # view-space z culling threshold
LOWPASS = 0.3            # pixel-space covariance dilation
RADIUS_SIGMA = 3.0       # extent = 3 sigma
FOV_CLAMP = 1.3          # clamp projected x/z, y/z to 1.3*tan(fov/2)


@dataclasses.dataclass
class ProjectedGaussians:
    """Screen-space primitives for one view."""

    xy: torch.Tensor        # (N, 2) pixel coordinates of the projected mean
    depth: torch.Tensor     # (N,)  view-space z
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    color: torch.Tensor     # (N, 3) RGB from SH
    opacity: torch.Tensor   # (N,)  activated opacity
    radius: torch.Tensor    # (N,)  screen-space extent in pixels (f32)
    valid: torch.Tensor     # (N,)  bool — survives near/degenerate culling


def _symm6_from_scales_rots(scales, rotations):
    """Σ = R diag(s²) Rᵀ as six (N,) components (s00,s01,s02,s11,s12,s22)."""
    w, x, y, z = (rotations[..., i] for i in range(4))
    r = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    s = (scales[..., 0], scales[..., 1], scales[..., 2])
    m = [[r[j][i] * s[i] for i in range(3)] for j in range(3)]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    return (
        dot3(m[0], m[0]), dot3(m[0], m[1]), dot3(m[0], m[2]),
        dot3(m[1], m[1]), dot3(m[1], m[2]), dot3(m[2], m[2]),
    )


def compute_cov2d_abc(mean_view, symm6, view_rot, focal_x, focal_y,
                      tan_half_fovx, tan_half_fovy):
    """EWA Σ₂ = J W Σ₃ Wᵀ Jᵀ + λI, scalar-expanded -> (a, b, c)."""
    z = mean_view[..., 2]
    lim_x = FOV_CLAMP * tan_half_fovx
    lim_y = FOV_CLAMP * tan_half_fovy
    txz = torch.clamp(mean_view[..., 0] / z, -lim_x, lim_x)
    tyz = torch.clamp(mean_view[..., 1] / z, -lim_y, lim_y)
    x = txz * z
    y = tyz * z

    inv_z = 1.0 / z
    fxz = focal_x * inv_z
    fyz = focal_y * inv_z
    gx = focal_x * x * inv_z * inv_z   # -J[0,2]
    gy = focal_y * y * inv_z * inv_z   # -J[1,2]
    W = view_rot
    t0 = tuple(fxz * W[0, k] - gx * W[2, k] for k in range(3))
    t1 = tuple(fyz * W[1, k] - gy * W[2, k] for k in range(3))

    s00, s01, s02, s11, s12, s22 = symm6

    def quad(u, v):
        return (
            u[0] * v[0] * s00 + u[1] * v[1] * s11 + u[2] * v[2] * s22
            + (u[0] * v[1] + u[1] * v[0]) * s01
            + (u[0] * v[2] + u[2] * v[0]) * s02
            + (u[1] * v[2] + u[2] * v[1]) * s12
        )

    a = quad(t0, t0) + LOWPASS
    b = quad(t0, t1)
    c = quad(t1, t1) + LOWPASS
    return a, b, c


def project_gaussians(means3d, shs, opacity, camera, sh_degree: int,
                      scales, rotations) -> ProjectedGaussians:
    """Project N Gaussians into one camera.

    means3d (N, 3) world means; shs (N, (d+1)², 3); opacity (N,) activated;
    scales (N, 3) activated; rotations (N, 4) normalized quaternions.  (The
    JAX function's ``cov3d`` input and ``screen_offset`` gradient hook are
    not ported: nothing on the coarse path uses them, and the hook needs
    the compositing backward of ROADMAP slice 2.)"""
    f32 = torch.float32
    means3d = means3d.to(f32)
    N = means3d.shape[0]
    hom = torch.cat([means3d, means3d.new_ones((N, 1))], dim=-1)

    p_view = hom @ camera.world_view_transform[..., :3]   # (N, 3)
    depth = p_view[..., 2]

    p_clip = hom @ camera.full_proj_transform             # (N, 4)
    w = p_clip[..., 3:4]
    safe_w = torch.where(w.abs() < 1e-7, torch.sign(w) * 1e-7 + 1e-12, w)
    ndc = p_clip[..., :3] / safe_w

    xy = torch.stack(
        [((ndc[..., 0] + 1.0) * camera.width - 1.0) * 0.5,
         ((ndc[..., 1] + 1.0) * camera.height - 1.0) * 0.5],
        dim=-1,
    )
    symm6 = _symm6_from_scales_rots(scales.to(f32), rotations.to(f32))
    view_rot = camera.world_view_transform[:3, :3].T   # R_w2c
    a, b, c = compute_cov2d_abc(
        p_view, symm6, view_rot, camera.focal_x, camera.focal_y,
        camera.tan_half_fovx, camera.tan_half_fovy,
    )

    det = a * c - b * b
    valid = (depth > NEAR_CULL) & (det > 0.0)
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(RADIUS_SIGMA * torch.sqrt(torch.clamp(lam1, min=0.0)))
    on_screen = (
        (xy[..., 0] + radius > 0)
        & (xy[..., 0] - radius < camera.width)
        & (xy[..., 1] + radius > 0)
        & (xy[..., 1] - radius < camera.height)
    )
    valid = valid & on_screen & (radius > 0)

    color = eval_sh_color(shs.to(f32), means3d - camera.camera_center, sh_degree)
    return ProjectedGaussians(
        xy=xy,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacity.to(f32),
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        valid=valid,
    )

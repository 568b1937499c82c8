"""Per-Gaussian view-space preprocessing (the EWA projection stage).

Port of ``generativedensification_tpu/splat/projection.py``: view transform
-> perspective Jacobian -> 2D covariance (+0.3 px low-pass) -> conic +
screen radius.  Matrices are row-vector form (``p_view = [p,1] @ w2c.T``),
pixel centers via ndc2Pix ``((ndc + 1) * S - 1) / 2``, activations applied
by the caller.

``project_gaussians`` is the plain op chain.  ``project`` is the renderer's
entry: it also normalises the rotations and folds validity into the
opacity.  Tensors on the card go through one launch of the ``project``
kernel (``csrc/prepass.cu``: it replaces no TPU kernel; XLA fuses the chain
there, eager PyTorch launched ~100 ops a view); CPU tensors take the plain
chain.  Where autograd records, the kernel's forward is wrapped in
``ProjectFunction``, whose backward recomputes the plain chain.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sh import eval_sh_color
from ..core.transforms import normalize_quat
from ..utils import tracing
from .kernels import MAIN_KERNELS, build, launch_counts

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
                      scales, rotations, screen_offset=None) -> ProjectedGaussians:
    """Project N Gaussians into one camera.

    means3d (N, 3) world means; shs (N, (d+1)², 3); opacity (N,) activated;
    scales (N, 3) activated; rotations (N, 4) normalized quaternions.
    ``screen_offset`` (N, 2), optional, is added to the projected means: the
    zero input through which the signed screen-space gradients are read.
    (The JAX function's ``cov3d`` input is not ported: nothing uses it.)"""
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
    if screen_offset is not None:
        xy = xy + screen_offset.to(f32)
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


def _project_plain(camera, sh_degree, means3d, shs, opacity, scales, rotations,
                   screen_offset):
    """``project``'s plain chain: (ProjectedGaussians, opacity_eff)."""
    proj = project_gaussians(means3d, shs, opacity, camera, sh_degree, scales,
                             normalize_quat(rotations), screen_offset)
    return proj, torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))


def _camera_tensors(camera):
    return (camera.world_view_transform, camera.full_proj_transform,
            camera.camera_center, camera.tan_half_fovx, camera.tan_half_fovy)


def _project_kernel(camera, sh_degree, means3d, shs, opacity, scales, rotations,
                    screen_offset) -> tuple:
    """One launch of the projection kernel: (xy, depth, conic, color,
    opacity_eff, radius, valid) for one view."""
    f32 = torch.float32
    dev = means3d.device
    N = means3d.shape[0]
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"the projection kernel takes SH degree 0-3, got {sh_degree}")
    f = lambda t: t.detach().to(f32).contiguous()
    means3d, shs, opacity, scales, rotations = (
        f(means3d), f(shs), f(opacity), f(scales), f(rotations))
    offset = None if screen_offset is None else f(screen_offset)
    for name, t, shape in (("means3d", means3d, (N, 3)), ("opacity", opacity, (N,)),
                           ("scales", scales, (N, 3)), ("rotations", rotations, (N, 4)),
                           ("screen_offset", offset, (N, 2))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if shs.dim() != 3 or shs.shape[0] != N or shs.shape[2] != 3 \
            or shs.shape[1] < (sh_degree + 1) ** 2:
        raise ValueError(f"shs must be ({N}, >= {(sh_degree + 1) ** 2}, 3), got "
                         f"{tuple(shs.shape)}")
    wvt, fpt, center, tanx, tany = _camera_tensors(camera)
    if any(t.device != dev or t.dtype != f32 for t in (wvt, fpt, center, tanx, tany)):
        raise ValueError("the camera's tensors must be float32 on the Gaussians' device")
    if wvt.shape != (4, 4) or fpt.shape != (4, 4) or center.shape != (3,) \
            or tanx.dim() or tany.dim():
        raise ValueError("the projection kernel takes one camera (no batch dims)")
    e = lambda shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    outs = (e((N, 2)), e(N), e((N, 3)), e((N, 3)), e(N), e(N), e(N, torch.bool))
    if N:
        lib = build(MAIN_KERNELS)["prepass"].lib
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            err = lib.gd_project(
                means3d.data_ptr(), shs.data_ptr(), shs.stride(0), opacity.data_ptr(),
                scales.data_ptr(), rotations.data_ptr(), ptr(offset), wvt.data_ptr(),
                *wvt.stride(), fpt.data_ptr(), *fpt.stride(), center.data_ptr(),
                center.stride(0), tanx.data_ptr(), tany.data_ptr(), N, camera.width,
                camera.height, sh_degree, *(o.data_ptr() for o in outs),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"project launch failed: CUDA error {err}")
        launch_counts["project"] += 1
    return outs


def _project_outputs(camera, sh_degree, *inputs) -> tuple:
    """``_project_kernel``'s outputs: from the kernel for card tensors, from
    the plain chain for CPU tensors."""
    if inputs[0].device.type != "cpu":
        return _project_kernel(camera, sh_degree, *inputs)
    proj, opacity_eff = _project_plain(camera, sh_degree, *inputs)
    return (proj.xy, proj.depth, proj.conic, proj.color, opacity_eff, proj.radius,
            proj.valid)


class ProjectFunction(torch.autograd.Function):
    """The projection with the kernel's forward (the plain chain for CPU
    tensors) and the plain chain's gradients: the backward recomputes
    ``_project_plain`` from the saved inputs under ``enable_grad`` and
    returns ``autograd.grad`` of its differentiable outputs (xy, depth,
    conic, color, opacity_eff), as ``models/init.py::remat_call`` does.
    ``apply(camera, sh_degree, means3d, shs, opacity, scales, rotations,
    screen_offset)`` -> ``_project_kernel``'s tuple.  The camera takes no
    gradient."""

    @staticmethod
    def forward(ctx, camera, sh_degree, *inputs):
        ctx.set_materialize_grads(False)
        ctx.camera, ctx.sh_degree = camera, sh_degree
        ctx.save_for_backward(*inputs)
        outs = _project_outputs(camera, sh_degree, *inputs)
        ctx.mark_non_differentiable(*outs[5:])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wrt = [t for t, n in zip(inputs, need) if n]
        with torch.enable_grad():
            proj, opacity_eff = _project_plain(ctx.camera, ctx.sh_degree, *inputs)
        pairs = [(o, g) for o, g in zip(
            (proj.xy, proj.depth, proj.conic, proj.color, opacity_eff), grads)
            if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs else [None] * len(wrt))
        tracing.count("project_recompute", 1)
        return (None, None, *(next(got) if n else None for n in need))


def project(means3d, shs, opacity, camera, sh_degree: int, scales, rotations,
            screen_offset=None) -> tuple:
    """The renderer's projection of one view: ``rotations`` normalised here,
    then ``project_gaussians``; returns (ProjectedGaussians, opacity_eff), the
    opacity zeroed where the Gaussian is culled.  Card tensors launch the
    ``project`` kernel (through ``ProjectFunction`` where autograd records;
    the camera then may not require a gradient); CPU tensors take the plain
    chain."""
    inputs = (means3d, shs, opacity, scales, rotations, screen_offset)
    if means3d.device.type == "cpu":
        return _project_plain(camera, sh_degree, *inputs)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        if any(t.requires_grad for t in _camera_tensors(camera)):
            raise ValueError("the projection kernel gives the camera no gradient")
        outs = ProjectFunction.apply(camera, sh_degree, *inputs)
    else:
        outs = _project_kernel(camera, sh_degree, *inputs)
    xy, depth, conic, color, opacity_eff, radius, valid = outs
    proj = ProjectedGaussians(xy=xy, depth=depth, conic=conic, color=color,
                              opacity=opacity.to(torch.float32), radius=radius,
                              valid=valid)
    return proj, opacity_eff

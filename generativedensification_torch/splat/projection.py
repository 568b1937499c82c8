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
``ProjectFunction``, whose backward is one launch of the ``project_bwd``
kernel on the card (eager PyTorch recomputed the chain and ran autograd
through it: ~960 ops a view) and, on the CPU, that recompute
(``project_vjp_recompute``).  ``project_vjp_plain`` is the backward
kernel's arithmetic as explicit PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sh import _C0, _C1, _C2, _C3, eval_sh_color, sh_basis
from ..core.transforms import normalize_quat, quat_to_rotmat
from .kernels import card_device, launch

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


def _compute_dtype(means3d) -> torch.dtype:
    return torch.float64 if means3d.dtype == torch.float64 else torch.float32


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
    Computes in float32, or in float64 for float64 means (with a float64
    camera).
    (The JAX function's ``cov3d`` input is not ported: nothing uses it.)"""
    dt = _compute_dtype(means3d)
    means3d = means3d.to(dt)
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
        xy = xy + screen_offset.to(dt)
    symm6 = _symm6_from_scales_rots(scales.to(dt), rotations.to(dt))
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

    color = eval_sh_color(shs.to(dt), means3d - camera.camera_center, sh_degree)
    return ProjectedGaussians(
        xy=xy,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacity.to(dt),
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


def _camera_args(tensors, dev, what="the projection kernel", items="Gaussians") -> tuple:
    """The camera's tensors (``_camera_tensors``, or the surfel set-up's
    ones without the projection matrix) as the pre-pass kernels take them:
    each tensor's device pointer and strides (no host copy)."""
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the camera's tensors must be float32 on the {items}' device")
    if [tuple(t.shape) for t in tensors] != [(4, 4)] * (len(tensors) - 3) + [(3,), (), ()]:
        raise ValueError(f"{what} takes one camera (no batch dims)")
    return tuple(a for t in tensors for a in (t.data_ptr(), *t.stride()))


def _check_shapes(n, sh_degree, shs, rows, what="the projection kernel") -> None:
    """The pre-pass kernels' SH degree (0-3), each (name, tensor, shape) of
    ``rows`` (``None`` tensors skipped) and ``shs`` (n, >= (d + 1)², 3)."""
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"{what} takes SH degree 0-3, got {sh_degree}")
    for name, t, shape in rows:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if shs.dim() != 3 or shs.shape[0] != n or shs.shape[2] != 3 \
            or shs.shape[1] < (sh_degree + 1) ** 2:
        raise ValueError(f"shs must be ({n}, >= {(sh_degree + 1) ** 2}, 3), got "
                         f"{tuple(shs.shape)}")


def _rows(n, means3d, opacity, scales, rotations, screen_offset) -> tuple:
    """The projection's per-Gaussian inputs beside ``shs``, with the shape
    each must have, for ``_check_shapes``."""
    return (("means3d", means3d, (n, 3)), ("opacity", opacity, (n,)),
            ("scales", scales, (n, 3)), ("rotations", rotations, (n, 4)),
            ("screen_offset", screen_offset, (n, 2)))


def _project_kernel(camera, sh_degree, means3d, shs, opacity, scales, rotations,
                    screen_offset) -> tuple:
    """One launch of the projection kernel: (xy, depth, conic, color,
    opacity_eff, radius, valid) for one view."""
    f32 = torch.float32
    N = means3d.shape[0]
    f = lambda t: t.detach().to(f32).contiguous()
    means3d, shs, opacity, scales, rotations = (
        f(means3d), f(shs), f(opacity), f(scales), f(rotations))
    offset = None if screen_offset is None else f(screen_offset)
    _check_shapes(N, sh_degree, shs, _rows(N, means3d, opacity, scales, rotations, offset))
    dev = card_device("project", means3d, shs, opacity, scales, rotations, offset)
    cam = _camera_args(_camera_tensors(camera), dev)
    e = lambda shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    outs = (e((N, 2)), e(N), e((N, 3)), e((N, 3)), e(N), e(N), e(N, torch.bool))
    if N:
        launch("project", dev, means3d.data_ptr(), shs.data_ptr(), shs.stride(0),
               opacity.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
               None if offset is None else offset.data_ptr(), *cam, N, camera.width,
               camera.height, sh_degree, *(o.data_ptr() for o in outs))
    return outs


def _project_outputs(camera, sh_degree, *inputs) -> tuple:
    """``_project_kernel``'s outputs: from the kernel for card tensors, from
    the plain chain for CPU tensors."""
    if inputs[0].device.type != "cpu":
        return _project_kernel(camera, sh_degree, *inputs)
    proj, opacity_eff = _project_plain(camera, sh_degree, *inputs)
    return (proj.xy, proj.depth, proj.conic, proj.color, opacity_eff, proj.radius,
            proj.valid)


# the differentiable outputs of the projection, their shapes for N Gaussians
_OUTPUT_SHAPES = (("xy", (2,)), ("depth", ()), ("conic", (3,)), ("color", (3,)),
                  ("opacity_eff", ()))


def project_vjp_recompute(camera, sh_degree, inputs, grads, need) -> tuple:
    """The projection's gradients by autograd: the plain chain
    (``_project_plain``) recomputed from ``inputs`` (means3d, shs, opacity,
    scales, rotations, screen_offset) under ``enable_grad``, then
    ``autograd.grad`` of its differentiable outputs (xy, depth, conic,
    color, opacity_eff) against ``grads``, their cotangents (``None`` for
    zero; an output that no asked input reaches takes none), as
    ``models/init.py::remat_call`` does.  Returns the six gradients, ``None``
    where ``need`` asks for none or none reaches."""
    inputs = [None if t is None else t.detach().requires_grad_(n)
              for t, n in zip(inputs, need)]
    wrt = [t for t, n in zip(inputs, need) if n]
    with torch.enable_grad():
        proj, opacity_eff = _project_plain(camera, sh_degree, *inputs)
    pairs = [(o, g) for o, g in zip(
        (proj.xy, proj.depth, proj.conic, proj.color, opacity_eff), grads)
        if g is not None and o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True)
               if pairs and wrt else [None] * len(wrt))
    return tuple(next(got) if n else None for n in need)


def _sh_basis_vjp(x, y, z, db, degree: int) -> tuple:
    """d(x, y, z) of sum_k db[k] * ``sh_basis(x, y, z, degree)[k]``."""
    dx, dy, dz = (torch.zeros_like(x) for _ in range(3))
    if degree >= 1:
        dy = dy - _C1 * db[0]
        dz = dz + _C1 * db[1]
        dx = dx - _C1 * db[2]
    if degree >= 2:
        dx = dx + _C2[0] * y * db[3] + _C2[3] * z * db[6] - 2.0 * _C2[2] * x * db[5] \
            + 2.0 * _C2[4] * x * db[7]
        dy = dy + _C2[0] * x * db[3] + _C2[1] * z * db[4] - 2.0 * _C2[2] * y * db[5] \
            - 2.0 * _C2[4] * y * db[7]
        dz = dz + _C2[1] * y * db[4] + 4.0 * _C2[2] * z * db[5] + _C2[3] * x * db[6]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        dx = (dx + _C3[0] * 6.0 * x * y * db[8] + _C3[1] * y * z * db[9]
              - _C3[2] * 2.0 * x * y * db[10] - _C3[3] * 6.0 * x * z * db[11]
              + _C3[4] * (4.0 * zz - 3.0 * xx - yy) * db[12]
              + _C3[5] * 2.0 * x * z * db[13] + _C3[6] * (3.0 * xx - 3.0 * yy) * db[14])
        dy = (dy + _C3[0] * (3.0 * xx - 3.0 * yy) * db[8] + _C3[1] * x * z * db[9]
              + _C3[2] * (4.0 * zz - xx - 3.0 * yy) * db[10]
              - _C3[3] * 6.0 * y * z * db[11] - _C3[4] * 2.0 * x * y * db[12]
              - _C3[5] * 2.0 * y * z * db[13] - _C3[6] * 6.0 * x * y * db[14])
        dz = (dz + _C3[1] * x * y * db[9] + _C3[2] * 8.0 * y * z * db[10]
              + _C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * db[11]
              + _C3[4] * 8.0 * x * z * db[12] + _C3[5] * (xx - yy) * db[13])
    return dx, dy, dz


def project_vjp_plain(camera, sh_degree, inputs, grads, need=(True,) * 6) -> tuple:
    """The ``project_bwd`` kernel's arithmetic as explicit PyTorch, with no
    autograd: the gradients of ``inputs`` (means3d, shs, opacity, scales,
    rotations, screen_offset) from ``grads``, the cotangents of
    ``_project_plain``'s differentiable outputs (xy, depth, conic, color,
    opacity_eff; ``None`` for zero).  The forward's values and branches are
    the plain chain's on the inputs widened as the kernel reads them (to
    float32, or float64 for float64 means); at each branch the gradient
    follows autograd's rule: ``torch.clamp`` passes it within its bounds,
    ends included (the FOV clamp, the colour's ``max(· + 0.5, 0)``),
    ``torch.where`` routes it to the chosen branch (``safe_w``,
    ``1 / where(valid0, det, 1)``, ``opacity_eff``), a norm's gradient is 0
    at a zero vector, and the radius (a ``ceil``) passes none.  Returns the
    six gradients, each in its input's dtype, ``None`` where ``need`` asks
    for none or the input is ``None``."""
    dt = _compute_dtype(inputs[0])
    m, sh, _, s, q, off = (None if t is None else t.detach().to(dt) for t in inputs)
    n = m.shape[0]
    with torch.no_grad():
        proj, _ = _project_plain(camera, sh_degree, m, sh, inputs[2].detach().to(dt),
                                 s, q, off)
    g_xy, g_depth, g_conic, g_color, g_opa = (
        m.new_zeros((n, *shape)) if g is None else g.to(dt)
        for g, (_, shape) in zip(grads, _OUTPUT_SHAPES))
    wvt, fpt = camera.world_view_transform, camera.full_proj_transform
    hom = torch.cat([m, m.new_ones((n, 1))], dim=-1)
    v0, v1, z = (hom @ wvt[..., :3]).unbind(-1)
    p_clip = hom @ fpt
    c0, c1, w = p_clip[..., 0], p_clip[..., 1], p_clip[..., 3]
    safe_w = torch.where(w.abs() < 1e-7, torch.sign(w) * 1e-7 + 1e-12, w)

    # the forward's covariance terms, as project_gaussians computes them
    nq = torch.linalg.norm(q, dim=-1, keepdim=True)
    qn = nq + 1e-8
    qh = q / qn
    symm6 = _symm6_from_scales_rots(s, qh)
    a, b, c = compute_cov2d_abc(torch.stack([v0, v1, z], -1), symm6, wvt[:3, :3].T,
                                camera.focal_x, camera.focal_y, camera.tan_half_fovx,
                                camera.tan_half_fovy)
    fx, fy = camera.focal_x, camera.focal_y
    lim_x, lim_y = FOV_CLAMP * camera.tan_half_fovx, FOV_CLAMP * camera.tan_half_fovy
    rx, ry = v0 / z, v1 / z
    txz, tyz = torch.clamp(rx, -lim_x, lim_x), torch.clamp(ry, -lim_y, lim_y)
    tx, ty = txz * z, tyz * z
    inv_z = 1.0 / z
    gx, gy = fx * tx * inv_z * inv_z, fy * ty * inv_z * inv_z
    R = wvt[:3, :3]                   # R[k, j]: view row j's weight of world k
    t0 = (fx * inv_z)[:, None] * R[:, 0] - gx[:, None] * R[:, 2]
    t1 = (fy * inv_z)[:, None] * R[:, 1] - gy[:, None] * R[:, 2]

    # the conic (c, -b, a) / where(valid0, det, 1)
    det = a * c - b * b
    valid0 = (z > NEAR_CULL) & (det > 0.0)
    inv_det = 1.0 / torch.where(valid0, det, torch.ones_like(det))
    gA, gB, gC = g_conic.unbind(-1)
    ddet = torch.where(valid0, -(gA * c - gB * b + gC * a) * inv_det * inv_det, 0.0)
    da = gC * inv_det + ddet * c
    db = -gB * inv_det - 2.0 * b * ddet
    dc = gA * inv_det + ddet * a
    # a = t0ᵀ Σ t0 + 0.3, b = t0ᵀ Σ t1, c = t1ᵀ Σ t1 + 0.3
    s00, s01, s02, s11, s12, s22 = symm6
    sig = torch.stack([torch.stack([s00, s01, s02], -1), torch.stack([s01, s11, s12], -1),
                       torch.stack([s02, s12, s22], -1)], -2)
    st0, st1 = ((sig @ t[..., None])[..., 0] for t in (t0, t1))
    dt0 = 2.0 * da[:, None] * st0 + db[:, None] * st1
    dt1 = 2.0 * dc[:, None] * st1 + db[:, None] * st0

    out = [None] * 6
    dp = None
    if need[0]:
        # t0 = fxz R[:, 0] - gx R[:, 2], t1 = fyz R[:, 1] - gy R[:, 2];
        # fxz = f_x / z, gx = f_x tx / z², tx = clamp(v0 / z) z
        dfxz, dfyz = (dt0 * R[:, 0]).sum(-1), (dt1 * R[:, 1]).sum(-1)
        dgx, dgy = -(dt0 * R[:, 2]).sum(-1), -(dt1 * R[:, 2]).sum(-1)
        dinv = dfxz * fx + dfyz * fy + 2.0 * inv_z * (dgx * fx * tx + dgy * fy * ty)
        dtx, dty = dgx * fx * inv_z * inv_z, dgy * fy * inv_z * inv_z
        dz = g_depth - dinv * inv_z * inv_z + dtx * txz + dty * tyz
        gxr = torch.where((rx >= -lim_x) & (rx <= lim_x), dtx * z, 0.0)
        gyr = torch.where((ry >= -lim_y) & (ry <= lim_y), dty * z, 0.0)
        dv0, dv1 = gxr / z, gyr / z
        dz = dz - gxr * v0 / (z * z) - gyr * v1 / (z * z)
        # xy = ((c / safe_w + 1) size - 1) / 2 + offset
        dn0, dn1 = g_xy[:, 0] * 0.5 * camera.width, g_xy[:, 1] * 0.5 * camera.height
        dc0, dc1 = dn0 / safe_w, dn1 / safe_w
        dw = torch.where(w.abs() < 1e-7, 0.0, -(dn0 * c0 + dn1 * c1) / (safe_w * safe_w))
        dp = (dv0[:, None] * R[:, 0] + dv1[:, None] * R[:, 1] + dz[:, None] * R[:, 2]
              + dc0[:, None] * fpt[:3, 0] + dc1[:, None] * fpt[:3, 1]
              + dw[:, None] * fpt[:3, 3])
    if need[3] or need[4]:
        # Σ = M Mᵀ, M = R(qh) diag(s): dM = G M
        G = (2.0 * (da[:, None, None] * t0[:, :, None] * t0[:, None, :]
                    + dc[:, None, None] * t1[:, :, None] * t1[:, None, :])
             + db[:, None, None] * (t0[:, :, None] * t1[:, None, :]
                                    + t1[:, :, None] * t0[:, None, :]))
        rot = quat_to_rotmat(qh)
        dm = G @ (rot * s[:, None, :])
        if need[3]:
            out[3] = (dm * rot).sum(-2)
        if need[4]:
            dr = dm * s[:, None, :]
            w_, x, y, z_ = qh.unbind(-1)
            e = lambda j, k: dr[:, j, k]
            dqh = 2.0 * torch.stack([
                -z_ * e(0, 1) + y * e(0, 2) + z_ * e(1, 0) - x * e(1, 2) - y * e(2, 0)
                + x * e(2, 1),
                y * e(0, 1) + z_ * e(0, 2) + y * e(1, 0) - 2.0 * x * e(1, 1) - w_ * e(1, 2)
                + z_ * e(2, 0) + w_ * e(2, 1) - 2.0 * x * e(2, 2),
                -2.0 * y * e(0, 0) + x * e(0, 1) + w_ * e(0, 2) + x * e(1, 0) + z_ * e(1, 2)
                - w_ * e(2, 0) + z_ * e(2, 1) - 2.0 * y * e(2, 2),
                -2.0 * z_ * e(0, 0) - w_ * e(0, 1) + x * e(0, 2) + w_ * e(1, 0)
                - 2.0 * z_ * e(1, 1) + y * e(1, 2) + x * e(2, 0) + y * e(2, 1)], -1)
            # qh = q / (|q| + 1e-8)
            gq = (dqh * q).sum(-1, keepdim=True)
            out[4] = dqh / qn - torch.where(nq > 0, gq / (qn * qn) / nq, 0.0) * q
    if need[0] or need[1]:
        # clamp(C0 sh0 + sum_k basis_k sh_k + 0.5, min=0) in the direction
        # (p - centre) / (|p - centre| + 1e-12)
        dirs = m - camera.camera_center
        nrm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
        den = nrm + 1e-12
        d = dirs / den
        basis = sh_basis(d[..., 0], d[..., 1], d[..., 2], sh_degree)
        channels = []
        for ch in range(3):
            acc = _C0 * sh[..., 0, ch]
            for k, bk in enumerate(basis):
                acc = acc + bk * sh[..., k + 1, ch]
            channels.append(acc)
        gc = torch.where(torch.stack(channels, dim=-1) + 0.5 >= 0, g_color, 0.0)
        if need[1]:
            dsh = torch.zeros_like(sh)
            dsh[:, 0] = _C0 * gc
            for k, bk in enumerate(basis):
                dsh[:, k + 1] = bk[:, None] * gc
            out[1] = dsh
        if need[0]:
            db_ = [(gc * sh[:, k + 1]).sum(-1) for k in range(len(basis))]
            dd = torch.stack(_sh_basis_vjp(d[..., 0], d[..., 1], d[..., 2], db_,
                                           sh_degree), -1)
            proj_d = (dd * dirs).sum(-1, keepdim=True) / (den * den)
            dp = dp + dd / den - torch.where(nrm > 0, proj_d / nrm, 0.0) * dirs
            out[0] = dp
    if need[2]:
        out[2] = torch.where(proj.valid, g_opa, 0.0)
    if need[5] and off is not None:
        out[5] = g_xy
    return tuple(None if g is None or t is None else g.to(t.dtype)
                 for g, t in zip(out, inputs))


def _project_vjp_kernel(camera, sh_degree, inputs, grads, need) -> tuple:
    """One launch of the ``project_bwd`` kernel: the gradients
    ``project_vjp_recompute`` gives, from the saved inputs in their stored
    dtype (float32 or bfloat16) and the cotangents; each gradient in its
    input's dtype, ``None`` where ``need`` asks for none."""
    means3d, shs, opacity, scales, rotations, offset = inputs
    dev = means3d.device
    N = means3d.shape[0]
    _check_shapes(N, sh_degree, shs, _rows(N, means3d, opacity, scales, rotations, offset))
    present = [t for t in inputs if t is not None]
    if any(t.dtype not in (torch.float32, torch.bfloat16) or t.device != dev
           for t in present):
        raise ValueError("the projection backward takes float32 or bfloat16 inputs on "
                         f"one device, got {[(t.dtype, str(t.device)) for t in present]}")
    cots = []
    for g, (name, shape) in zip(grads, _OUTPUT_SHAPES):
        if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != (N, *shape)
                              or g.device != dev):
            raise ValueError(f"the cotangent of {name} must be ({N}, {shape}) float32 on "
                             f"the inputs' device, got {tuple(g.shape)} {g.dtype}")
        cots.append(None if g is None else g.contiguous())
    cam = _camera_args(_camera_tensors(camera), dev)
    # rows may lie apart (the network's attribute slices); within a row packed
    packed = lambda t, inner: t if t is None or t.stride()[1:] == inner else t.contiguous()
    means3d, scales, rotations, offset = (
        packed(means3d, (1,)), packed(scales, (1,)), packed(rotations, (1,)),
        packed(offset, (1,)))
    shs = packed(shs, (3, 1))
    outs = [torch.empty(t.shape, dtype=t.dtype, device=dev) if n and t is not None
            else None for t, n in zip(inputs, need)]
    if N:
        ptr = lambda t: None if t is None else t.data_ptr()
        row = lambda t: 0 if t is None else t.stride(0)
        bf16 = sum(1 << k for k, t in enumerate(inputs)
                   if t is not None and t.dtype == torch.bfloat16)
        launch("project_bwd", dev, means3d.data_ptr(), row(means3d), shs.data_ptr(),
               row(shs), shs.shape[1], scales.data_ptr(), row(scales),
               rotations.data_ptr(), row(rotations), ptr(offset), row(offset), bf16,
               *(ptr(g) for g in cots), *(ptr(o) for o in outs), *cam, N, camera.width,
               camera.height, sh_degree)
    return tuple(outs)


class ProjectFunction(torch.autograd.Function):
    """The projection with the kernel's forward (the plain chain for CPU
    tensors) and the plain chain's gradients: on the card one launch of the
    ``project_bwd`` kernel, for CPU tensors ``project_vjp_recompute``.
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
        inputs = ctx.saved_tensors
        vjp = (project_vjp_recompute if inputs[0].device.type == "cpu"
               else _project_vjp_kernel)
        return (None, None, *vjp(ctx.camera, ctx.sh_degree, inputs, grads[:5],
                                 ctx.needs_input_grad[2:]))


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

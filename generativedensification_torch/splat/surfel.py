"""2DGS surfel rasterizer, PyTorch.

Port of ``generativedensification_tpu/splat/surfel.py``.  Each primitive is a
planar Gaussian disk: center p, tangent axes ``sx·t_u`` and ``sy·t_v`` (the
rotation's first two columns), normal ``t_w``.  A pixel (X, Y) meets the
disk's plane where the homogeneous map ``M: (u, v, 1) -> (x·w, y·w, w)``
says, and the cross product that solves for (u, v) is affine in the pixel:

    cr(X, Y) = Mx×My + X·(My×Mw) + Y·(Mw×Mx),   z_hit = det(M) / cr_z,

so every surfel carries the ten coefficients acr, bcr, ccr, det
(``_surfel_coeffs``).  Outputs: image, alpha, expected depth, median depth
(the depth at the T = 0.5 crossing), the view-space normal map and the
distortion map of the 2DGS regularizers.

The per-surfel set-up is ``surfel_setup``: one launch of the
``surfel_setup`` kernel (``csrc/prepass.cu``) for card tensors that no
autograd records, the plain chain (``_surfel_setup``, ``_surfel_coeffs``)
for CPU tensors and for training.  The per-tile work is
``surfel_kernels.surfel_fwd`` / ``surfel_bwd`` (the CUDA kernels for tensors
on the card, their plain versions for CPU tensors).
``composite_surfels_backward`` turns the six output cotangents into
per-surfel gradients (``full``) or the AbsGS selection gradients
(``selonly``), summing each surfel's slot rows by ``composite.APOS_MODE``.
``composite_surfels`` is differentiable: its autograd backward is the
``full`` mode, on the forward kernel's saved output rows and table.
``composite_surfels_sel`` also runs ``selonly`` against the image-MSE
cotangent inside its forward (the fused selection); its autograd backward is
``full`` as well, with zero gradients for ``gt`` and ``sel_abs``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sh import eval_sh_color
from ..core.transforms import normalize_quat
from ..utils import tracing
from .binning import bin_and_cap
from .composite import _tile, _untile, mse_image_cotangent, slots_to_gaussians
from .kernels import MAIN_KERNELS, build, launch_counts
from .projection import ProjectedGaussians
from .surfel_kernels import (
    BX,
    CX,
    DET,
    FILTER_2D_VAR,
    NEAR_CULL,
    NX,
    OPA,
    PX,
    R,
    RAD,
    TABLE_W,
    surfel_bwd,
    surfel_fwd,
)


# the screen radius's filter margin 3·sqrt(FILTER_2D_VAR) in f32, as the JAX
# package rounds it: a Python float, so that no render copies it to the card
MARGIN = float(3.0 * torch.sqrt(torch.tensor(FILTER_2D_VAR, dtype=torch.float32)))


@dataclasses.dataclass
class SurfelOutput:
    image: torch.Tensor           # (H, W, 3) in [0, 1] (clamped)
    alpha: torch.Tensor           # (H, W)
    depth_expected: torch.Tensor  # (H, W) Σ w·z (not divided by alpha)
    depth_median: torch.Tensor    # (H, W) depth at the T = 0.5 crossing
    normal: torch.Tensor          # (H, W, 3) view-space, alpha-weighted
    dist: torch.Tensor            # (H, W) distortion
    radii: torch.Tensor           # (N,)
    overflow: torch.Tensor        # () binning + per-tile cap overflow
    sel_abs: torch.Tensor | None = None  # (N, 2) AbsGS selection grads
                                         # (only with rasterize_surfels(sel_gt=...))


def _rot_cols(q):
    """Rotation-matrix columns of (N, 4) wxyz quaternions as (N, 3)
    vectors, scalar-expanded."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    c0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                      2 * (x * z - w * y)], dim=-1)
    c1 = torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)], dim=-1)
    c2 = torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)], dim=-1)
    return c0, c1, c2


def _surfel_setup(means3d, scales2d, rotations, opacity, shs, camera,
                  sh_degree):
    """Per-surfel screen maps and culling.  Returns (M (N, 3, 3), view
    normal flipped toward the camera, center_xy, center depth, SH color,
    radius (0 where culled), valid)."""
    del opacity  # the JAX signature carries it; culling does not use it
    f32 = torch.float32
    t_u, t_v, normal_w = _rot_cols(normalize_quat(rotations.to(f32)))
    t_u = t_u * scales2d[..., 0:1]
    t_v = t_v * scales2d[..., 1:2]

    wvt = camera.world_view_transform      # (4, 4), row-vector w2c.T
    Rv = wvt[:3, :3]
    tv = wvt[3, :3]
    p_view = means3d.to(f32) @ Rv + tv
    tu_view = t_u @ Rv
    tv_view = t_v @ Rv
    n_view = normal_w @ Rv
    flip = torch.sign(torch.sum(n_view * p_view, dim=-1, keepdim=True))
    n_view = -flip * n_view

    fx, fy = camera.focal_x, camera.focal_y
    cx = (camera.width - 1.0) / 2.0
    cy = (camera.height - 1.0) / 2.0

    def pix_row(v):
        """View-space point or direction -> pixel-homogeneous (x·w, y·w, w)."""
        return torch.stack([fx * v[..., 0] + cx * v[..., 2],
                            fy * v[..., 1] + cy * v[..., 2], v[..., 2]], dim=-1)

    # M's columns are the images of t_u, t_v and the center, so its rows are
    # the (x, y, w) linear forms over (u, v, 1)
    M = torch.stack([pix_row(tu_view), pix_row(tv_view), pix_row(p_view)],
                    dim=-1)

    depth = p_view[..., 2]
    w = torch.clamp(depth, min=1e-6)
    center_xy = torch.stack([fx * p_view[..., 0] / w + cx,
                             fy * p_view[..., 1] / w + cy], dim=-1)

    # conservative screen radius: project the four ±3σ axis endpoints
    ends = torch.stack([p_view + 3.0 * tu_view, p_view - 3.0 * tu_view,
                        p_view + 3.0 * tv_view, p_view - 3.0 * tv_view], dim=1)
    ze = torch.clamp(ends[..., 2], min=1e-6)
    exy = torch.stack([fx * ends[..., 0] / ze + cx, fy * ends[..., 1] / ze + cy],
                      dim=-1)
    radius = torch.linalg.vector_norm(exy - center_xy[:, None], dim=-1).amax(dim=1)
    radius = torch.ceil(radius + MARGIN)

    valid = (depth > NEAR_CULL) & (ends[..., 2].amin(dim=1) > 0.05)
    on_screen = (
        (center_xy[..., 0] + radius > 0)
        & (center_xy[..., 0] - radius < camera.width)
        & (center_xy[..., 1] + radius > 0)
        & (center_xy[..., 1] - radius < camera.height)
    )
    valid = valid & on_screen
    color = eval_sh_color(shs.to(f32), means3d - camera.camera_center, sh_degree)
    return (M, n_view, center_xy, depth, color,
            torch.where(valid, radius, torch.zeros_like(radius)), valid)


def _surfel_coeffs(M):
    """Affine ray-intersection coefficients of the homogeneous map:
    cr(X, Y) = acr + X·bcr + Y·ccr and z_hit = det / cr_z."""
    Mx, My, Mw = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    acr = torch.linalg.cross(Mx, My, dim=-1)
    bcr = torch.linalg.cross(My, Mw, dim=-1)
    ccr = torch.linalg.cross(Mw, Mx, dim=-1)
    det = torch.sum(Mw * acr, dim=-1)
    return acr, bcr, ccr, det


def pack_surfel_table(acr, bcr, ccr, det, xy, rad, color, opacity,
                      normal) -> torch.Tensor:
    """Per-surfel (N, 24) table in the kernels' row layout (the attribute
    order of the Pallas slab, padded to 96 bytes)."""
    N = det.shape[0]
    f = lambda v: v.to(torch.float32)
    return torch.cat(
        [f(acr), f(bcr), f(ccr), f(det)[:, None], f(xy), f(opacity)[:, None],
         f(color), f(normal), f(rad)[:, None], det.new_zeros((N, TABLE_W - 20))],
        dim=-1,
    ).contiguous()


def _maps(out, bg, tiles_x, tiles_y, ts):
    """Forward kernel rows (T, 13, ts²) -> (image with T_fin·bg, alpha,
    expected depth, median depth, normal, dist) at tile-padded size."""
    un = lambda x, ch: _untile(x, tiles_x, tiles_y, ts, ch)
    un1 = lambda x: un(x[..., None], 1)[..., 0]
    T_fin = out[:, 12]
    image_t = out[:, 0:3].transpose(1, 2) + T_fin[..., None] * bg.to(torch.float32)
    return (un(image_t, 3), un1(1.0 - T_fin), un1(out[:, 6]), un1(out[:, 7]),
            un(out[:, 3:6].transpose(1, 2), 3), un1(out[:, 8]))


class CompositeSurfels(torch.autograd.Function):
    """``composite_surfels``: the forward kernel, and the backward kernel in
    ``full`` mode as its autograd backward."""

    @staticmethod
    def forward(ctx, acr, bcr, ccr, det, xy, rad, color, opacity, normal, bg,
                planes, bins, dims, n_slots):
        with tracing.span("gd.composite"):
            table = pack_surfel_table(acr, bcr, ccr, det, xy, rad, color, opacity,
                                      normal)
            sorted_ids, _, _, tile_starts, tile_counts = bins
            out = surfel_fwd(table, sorted_ids, tile_starts, tile_counts, planes,
                             *dims)
            maps = _maps(out, bg, *dims)
        ctx.save_for_backward(table, out, bg, planes)
        ctx.bins, ctx.dims, ctx.n_slots = bins, dims, n_slots
        return maps

    @staticmethod
    def backward(ctx, *g_maps):
        return _full_backward(ctx, g_maps) + (None,)


def _full_backward(ctx, g_maps):
    """The ``full`` backward of a surfel composite from the saved forward
    rows: gradients in ``composite_surfels``' argument order up to
    ``dims`` (``rad``, ``planes``, ``bins`` and ``dims`` get none)."""
    table, out, bg, planes = ctx.saved_tensors
    (d_acr, d_bcr, d_ccr, d_det, d_xy, d_col, d_opa, d_nrm, d_bg), _ = \
        composite_surfels_backward(table, out, bg, g_maps, planes, ctx.bins,
                                   ctx.dims, ctx.n_slots, "full")
    return (d_acr, d_bcr, d_ccr, d_det, d_xy, None, d_col, d_opa, d_nrm, d_bg,
            None, None, None)


def composite_surfels(acr, bcr, ccr, det, xy, rad, color, opacity, normal, bg,
                      planes, bins, dims, n_slots: int):
    """Composite N surfels -> (image, alpha, depth_exp, depth_med, normal,
    dist), each (H', W'[, 3]) at tile-padded size (differentiable; ``rad``
    takes no gradient).

    ``planes`` (2,) [znear, zfar]; ``bins`` (sorted_ids, sorted_o,
    depth_order, tile_starts, tile_counts) with the counts clamped to the
    per-tile cap; ``dims`` (tiles_x, tiles_y, tile_size); ``n_slots`` the
    slot-major extent N·max_tiles of ``sorted_o``.  ``rad`` is the screen
    truncation radius: pixels farther than ``rad`` from the filter center
    get nothing, which makes the binning's circle cull exact."""
    return CompositeSurfels.apply(acr, bcr, ccr, det, xy, rad, color, opacity,
                                  normal, bg, planes, bins, dims, n_slots)


def _bwd_rows(out, bg, cot, dims, mode):
    """The backward kernel's per-pixel inputs: the tiled cotangent rows cot8
    = [gC, gN, gDexp, gdist] and the totals aux5 = [G2, gDmed, ΣW, M1, M2],
    G2 = G + dL/dT_fin with G = gC·C + gN·N + gDexp·Dexp + 2·gdist·dist
    (Σ_k w_k ∂dist/∂w_k = 2·dist); and d_bg.  ``selonly`` reads the image
    cotangent only."""
    tiles_x, tiles_y, ts = dims
    full = mode == "full"
    T_fin = out[:, 12]
    zeros = torch.zeros_like(T_fin)
    t3 = lambda v: (zeros[..., None].expand(-1, -1, 3) if v is None
                    else _tile(v, tiles_x, tiles_y, ts))
    t1 = lambda v: (zeros if v is None
                    else _tile(v[..., None], tiles_x, tiles_y, ts)[..., 0])
    gC_img, gA_img, gDexp_img, gDmed_img, gN_img, gdist_img = cot
    if not full:
        gA_img = gDexp_img = gDmed_img = gN_img = gdist_img = None
    gC, gN = t3(gC_img), t3(gN_img)                        # (T, ts², 3)
    gA, gDexp, gDmed, gdist = t1(gA_img), t1(gDexp_img), t1(gDmed_img), t1(gdist_img)
    G = (gC * out[:, 0:3].transpose(1, 2)).sum(-1)
    if full:
        G = (G + (gN * out[:, 3:6].transpose(1, 2)).sum(-1) + gDexp * out[:, 6]
             + 2.0 * gdist * out[:, 8])
    G2 = G + ((gC * bg.to(torch.float32)).sum(-1) - gA) * T_fin
    cot8 = torch.cat([gC.transpose(1, 2), gN.transpose(1, 2), gDexp[:, None],
                      gdist[:, None]], dim=1).contiguous()
    aux5 = torch.stack([G2, gDmed, out[:, 9], out[:, 10], out[:, 11]],
                       dim=1).contiguous()
    return cot8, aux5, torch.einsum("tpc,tp->c", gC, T_fin)


def composite_surfels_backward(table, out, bg, cot, planes, bins, dims,
                               n_slots: int, mode: str = "full"):
    """Per-surfel compositing gradients from the forward kernel's rows
    ``out`` and the cotangents ``cot`` = (image, alpha, depth_exp,
    depth_med, normal, dist) at tile-padded size (``None`` for a zero one).

    The preamble of the JAX ``pallas_surfel_bwd`` (``_bwd_rows``), kernel
    #4, then the per-surfel sum over each surfel's slots.  Returns
    ``(grads, sel_abs)``: ``full`` gives grads = (d_acr, d_bcr, d_ccr, d_det,
    d_xy, d_color, d_opacity, d_normal, d_bg) and sel_abs None; ``selonly``
    (which reads only the image cotangent) gives grads None and sel_abs
    (N, 2)."""
    sorted_ids, sorted_o, depth_order, tile_starts, tile_counts = bins
    cot8, aux5, d_bg = _bwd_rows(out, bg, cot, dims, mode)
    rows = surfel_bwd(table, sorted_ids, tile_starts, tile_counts, planes, cot8,
                      aux5, *dims, mode)
    g = slots_to_gaussians(rows, sorted_o, depth_order, n_slots)
    if mode != "full":
        return None, g
    grads = (g[:, 0:BX], g[:, BX:CX], g[:, CX:DET], g[:, DET], g[:, PX:OPA],
             g[:, R:NX], g[:, OPA], g[:, NX:RAD], d_bg)
    return grads, None


class CompositeSurfelsSel(torch.autograd.Function):
    """``composite_surfels_sel``: the forward kernel and one ``selonly``
    backward launch in the forward; the ``full`` backward as its autograd
    backward (zero gradients for ``gt`` and ``sel_abs``)."""

    @staticmethod
    def forward(ctx, acr, bcr, ccr, det, xy, rad, color, opacity, normal, bg,
                planes, gt, bins, dims, n_slots):
        with tracing.span("gd.composite"):
            table = pack_surfel_table(acr, bcr, ccr, det, xy, rad, color, opacity,
                                      normal)
            sorted_ids, _, _, tile_starts, tile_counts = bins
            out = surfel_fwd(table, sorted_ids, tile_starts, tile_counts, planes,
                             *dims)
            maps = _maps(out, bg, *dims)
        with tracing.span("gd.sel_bwd"):
            cot = (mse_image_cotangent(maps[0], gt.to(torch.float32)),
                   None, None, None, None, None)
            _, sel_abs = composite_surfels_backward(table, out, bg, cot, planes,
                                                    bins, dims, n_slots, "selonly")
        ctx.mark_non_differentiable(sel_abs)
        ctx.save_for_backward(table, out, bg, planes)
        ctx.bins, ctx.dims, ctx.n_slots = bins, dims, n_slots
        return (*maps, sel_abs)

    @staticmethod
    def backward(ctx, *grads):
        g = _full_backward(ctx, grads[:6])
        return g[:11] + (None,) + g[11:] + (None,)


def composite_surfels_sel(acr, bcr, ccr, det, xy, rad, color, opacity, normal,
                          bg, planes, gt, bins, dims, n_slots: int = 0):
    """``composite_surfels`` that also emits the AbsGS selection gradients.

    Returns the six maps and ``sel_abs`` (N, 2): the absolute screen-
    translation gradients of the image MSE against ``gt`` (H, W, 3).
    Translating a surfel by (ox, oy) on the screen moves its affine
    coefficients (a -> a - B·ox - C·oy) and its filter center (p -> p + o);
    one ``selonly`` application of the backward kernel to the forward's own
    rows gives them (no second render).  ``bins``, ``dims`` and ``n_slots``
    as ``composite_surfels`` takes them (``n_slots`` 0: the number of
    sorted slots)."""
    return CompositeSurfelsSel.apply(
        acr, bcr, ccr, det, xy, rad, color, opacity, normal, bg, planes, gt,
        bins, dims, n_slots or bins[0].shape[0])


def _surfel_plain(camera, sh_degree, means3d, scales2d, rotations, opacities,
                  shs) -> tuple:
    """``surfel_setup``'s plain chain."""
    M, n_view, xy, depth, color, radius, valid = _surfel_setup(
        means3d, scales2d, rotations, opacities, shs, camera, sh_degree)
    acr, bcr, ccr, det = _surfel_coeffs(M)
    # The compositor cuts every surfel at its screen radius R, so an
    # isotropic conic lam = 2·tau/R² makes bin_gaussians' ellipse bound fire
    # exactly at screen distance d > R; the floor on tau keeps lam a valid
    # conic for surfels that can contribute nothing (opacity <= 1/255), so
    # that all their tiles are culled.
    opacity_f = opacities.to(torch.float32)
    tau = torch.log(torch.clamp(opacity_f, min=1e-12) * 255.0)
    lam = 2.0 * torch.clamp(tau, min=1e-6) / torch.clamp(radius, min=1.0) ** 2
    conic = torch.stack([lam, torch.zeros_like(lam), lam], dim=-1)
    opacity_eff = torch.where(valid, opacity_f, torch.zeros_like(opacity_f))
    return (acr, bcr, ccr, det, xy, depth, conic, color, opacity_eff, radius, valid,
            n_view)


def _surfel_camera(camera):
    return (camera.world_view_transform, camera.camera_center, camera.tan_half_fovx,
            camera.tan_half_fovy)


def _surfel_setup_kernel(camera, sh_degree, means3d, scales2d, rotations,
                         opacities, shs) -> tuple:
    """One launch of the surfel set-up kernel: ``surfel_setup``'s tuple for
    one view."""
    f32 = torch.float32
    dev = means3d.device
    N = means3d.shape[0]
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"the surfel set-up kernel takes SH degree 0-3, got {sh_degree}")
    f = lambda t: t.detach().to(f32).contiguous()
    means3d, rotations, opacities, shs = f(means3d), f(rotations), f(opacities), f(shs)
    scales2d = scales2d.detach().to(f32)
    if scales2d.dim() != 2 or scales2d.stride(-1) != 1:
        scales2d = scales2d.contiguous()
    for name, t, shape in (("means3d", means3d, (N, 3)), ("scales2d", scales2d, (N, 2)),
                           ("rotations", rotations, (N, 4)), ("opacities", opacities, (N,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if shs.dim() != 3 or shs.shape[0] != N or shs.shape[2] != 3 \
            or shs.shape[1] < (sh_degree + 1) ** 2:
        raise ValueError(f"shs must be ({N}, >= {(sh_degree + 1) ** 2}, 3), got "
                         f"{tuple(shs.shape)}")
    wvt, center, tanx, tany = _surfel_camera(camera)
    if any(t.device != dev or t.dtype != f32 for t in (wvt, center, tanx, tany)):
        raise ValueError("the camera's tensors must be float32 on the surfels' device")
    if wvt.shape != (4, 4) or center.shape != (3,) or tanx.dim() or tany.dim():
        raise ValueError("the surfel set-up kernel takes one camera (no batch dims)")
    e = lambda shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    outs = (e((N, 3)), e((N, 3)), e((N, 3)), e(N), e((N, 2)), e(N), e((N, 3)),
            e((N, 3)), e(N), e(N), e(N, torch.bool), e((N, 3)))
    if N:
        lib = build(MAIN_KERNELS)["prepass"].lib
        with torch.cuda.device(dev):
            err = lib.gd_surfel_setup(
                means3d.data_ptr(), scales2d.data_ptr(), scales2d.stride(0),
                rotations.data_ptr(), opacities.data_ptr(), shs.data_ptr(), shs.stride(0),
                wvt.data_ptr(), *wvt.stride(), center.data_ptr(), center.stride(0),
                tanx.data_ptr(), tany.data_ptr(), N, camera.width, camera.height,
                sh_degree, MARGIN, *(o.data_ptr() for o in outs),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"surfel_setup launch failed: CUDA error {err}")
        launch_counts["surfel_setup"] += 1
    return outs


def surfel_setup(means3d, scales2d, rotations, opacities, shs, camera,
                 sh_degree: int) -> tuple:
    """Screen set-up of N activated surfels in one camera: (acr, bcr, ccr,
    det, xy, depth, conic, color, opacity_eff, radius, valid, normal), the
    binning's circular conic and the opacity zeroed where the surfel is
    culled.  Card tensors launch the ``surfel_setup`` kernel
    (``csrc/prepass.cu``: bit for bit the plain chain where its library
    orders are the measured ones); CPU tensors, and any call that autograd
    records, take the plain chain (``_surfel_setup``, ``_surfel_coeffs``)."""
    inputs = (means3d, scales2d, rotations, opacities, shs)
    if means3d.device.type == "cpu" or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (*inputs, *_surfel_camera(camera)))):
        return _surfel_plain(camera, sh_degree, *inputs)
    return _surfel_setup_kernel(camera, sh_degree, *inputs)


def _planes(camera, dev) -> torch.Tensor:
    """(2,) f32 [znear, zfar] on ``dev``, made there (no host copy)."""
    on = lambda v: (v.to(torch.float32) if isinstance(v, torch.Tensor) and v.device == dev
                    else torch.full((), float(v), dtype=torch.float32, device=dev))
    return torch.stack([on(camera.znear), on(camera.zfar)])


@dataclasses.dataclass
class SurfelInputs:
    """What the compositing boundary takes for one view."""

    attrs: tuple            # acr, bcr, ccr, det, xy, rad, color, opacity, normal
    planes: torch.Tensor    # (2,) [znear, zfar]
    bins: tuple             # sorted_ids, sorted_o, depth_order, tile_starts,
                            # clamped counts
    dims: tuple             # tiles_x, tiles_y, tile_size
    n_slots: int            # N · max_tiles, the extent of sorted_o
    radius: torch.Tensor    # (N,)
    overflow: torch.Tensor  # () binning + per-tile cap overflow


def surfel_inputs(means3d, shs, opacities, scales2d, rotations, camera,
                  sh_degree: int = 1, tile_size: int = 32, max_tiles: int = 16,
                  max_per_tile: int = 4096,
                  enum_tiles: int | None = None) -> SurfelInputs:
    """Screen setup and tile binning of N activated surfels in one camera
    (the part of ``rasterize_surfels`` before compositing)."""
    N = means3d.shape[0]
    max_per_tile = min(max_per_tile, N * max_tiles)
    with tracing.span("gd.project"):
        (acr, bcr, ccr, det, xy, depth, conic, color, opacity_eff, radius, valid,
         n_view) = surfel_setup(means3d, scales2d, rotations, opacities, shs, camera,
                                sh_degree)
    proj = ProjectedGaussians(xy=xy, depth=depth, conic=conic, color=color,
                              opacity=opacities.to(torch.float32), radius=radius,
                              valid=valid)
    with tracing.span("gd.bin"):
        bins, tile_counts, overflow = bin_and_cap(
            proj, camera.height, camera.width, tile_size, max_tiles, max_per_tile,
            enum_tiles=enum_tiles)
    return SurfelInputs(
        attrs=(acr, bcr, ccr, det, xy, radius.detach(), color, opacity_eff, n_view),
        planes=_planes(camera, xy.device),
        bins=(bins.sorted_ids, bins.sorted_o, bins.depth_order, bins.tile_starts,
              tile_counts),
        dims=(bins.tiles_x, bins.tiles_y, tile_size),
        n_slots=N * max_tiles,
        radius=radius,
        overflow=overflow,
    )


@tracing.traced("gd.render")
def rasterize_surfels(means3d, shs, opacities, scales2d, rotations, camera, bg,
                      sh_degree: int = 1, tile_size: int = 32,
                      max_tiles: int = 16, max_per_tile: int = 4096,
                      enum_tiles: int | None = None,
                      sel_gt: torch.Tensor | None = None) -> SurfelOutput:
    """Splat N activated surfels into one camera.

    means3d (N, 3); shs (N, (d+1)², 3); opacities (N,) activated; scales2d
    (N, 2) activated; rotations (N, 4) quaternions (normalized here);
    camera a ``core.Camera``; bg (3,).  ``sel_gt`` (H, W, 3): the output
    also carries ``sel_abs``, the AbsGS selection gradients of the image MSE
    against it, from the same forward.  (The JAX ``chunk`` and ``backend``
    arguments have no meaning here.)"""
    H, W = camera.height, camera.width
    si = surfel_inputs(means3d, shs, opacities, scales2d, rotations, camera,
                       sh_degree, tile_size, max_tiles, max_per_tile, enum_tiles)
    args = (*si.attrs, bg.to(torch.float32), si.planes)
    sel_abs = None
    if sel_gt is not None:
        *maps, sel_abs = composite_surfels_sel(*args, sel_gt, si.bins, si.dims,
                                               si.n_slots)
    else:
        maps = composite_surfels(*args, si.bins, si.dims, si.n_slots)
    image, alpha, dexp, dmed, nacc, dist = maps
    return SurfelOutput(
        image=torch.clamp(image[:H, :W], 0.0, 1.0),
        alpha=alpha[:H, :W],
        depth_expected=dexp[:H, :W],
        depth_median=dmed[:H, :W],
        normal=nacc[:H, :W],
        dist=dist[:H, :W],
        radii=si.radius,
        overflow=si.overflow,
        sel_abs=sel_abs,
    )


def depth_to_normal(depth: torch.Tensor, rays: torch.Tensor,
                    alpha: torch.Tensor) -> torch.Tensor:
    """Pseudo surface normal (H, W, 3) from a depth map via cross products
    of the ray-lifted point grid; zero on the border and where alpha <= 0.05."""
    o, d = rays[..., :3], rays[..., 3:6]
    pts = o + d * depth[..., None]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    out = torch.zeros_like(pts)
    out[1:-1, 1:-1] = n
    return out * (alpha[..., None] > 0.05)


def surface_depth(out: SurfelOutput, depth_ratio: float) -> torch.Tensor:
    """(H, W) expected depth / alpha blended with the median depth by
    ``depth_ratio``."""
    exp_norm = out.depth_expected / torch.clamp(out.alpha, min=1e-6)
    return (1.0 - depth_ratio) * exp_norm + depth_ratio * out.depth_median


class Renderer2DGS:
    """Object wrapper mirroring the reference 2DGS ``Renderer`` surface:
    ``render_img`` returns the 3DGS keys plus ``rend_dist``,
    ``rend_normal`` and (with rays) ``depth_normal``.  Device rules as
    ``rasterizer.Renderer``: ``device=None`` is the card."""

    def __init__(self, sh_degree: int = 1, white_background: bool = True,
                 radius: float = 1.0, depth_ratio: float = 0.0, device=None):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.sh_degree = sh_degree
        self.radius = radius
        self.depth_ratio = depth_ratio
        self.bg_color = (torch.ones(3) if white_background
                         else torch.zeros(3)).to(self.device)

    def render_img(self, cam, rays, centers, shs, opacity, scales, rotations,
                   bg_color=None, prex: str = "", **kw) -> dict:
        bg = self.bg_color if bg_color is None else torch.as_tensor(
            bg_color, dtype=torch.float32, device=self.device)
        out = rasterize_surfels(
            centers, shs.reshape(shs.shape[0], -1, 3), opacity.reshape(-1),
            scales[..., :2], rotations, cam, bg, self.sh_degree, **kw)
        surf_depth = surface_depth(out, self.depth_ratio)
        result = {
            f"image{prex}": out.image,
            f"depth{prex}": surf_depth[..., None],
            f"acc_map{prex}": out.alpha,
            f"rend_dist{prex}": out.dist,
            f"rend_normal{prex}": out.normal @ cam.world_view_transform[:3, :3].T,
            f"radii{prex}": out.radii,
        }
        if rays is not None:
            result[f"depth_normal{prex}"] = depth_to_normal(surf_depth, rays,
                                                            out.alpha)
        return result

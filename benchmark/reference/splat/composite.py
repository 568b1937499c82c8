"""Front-to-back alpha compositing over per-tile depth-ordered segments:
the benchmark's frozen copy of the port's ``splat/composite.py``.

Port of ``generativedensification_tpu/splat/composite.py`` (semantics pinned
to the 3DGS CUDA rasterizer):
  * power = -0.5 (a dx² + c dy²) - b dx dy, clamped at 0,
  * alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255,
  * a pixel stops before the Gaussian that would drop its transmittance
    below 1e-4,
  * outputs: color (+ T_final·bg), alpha map 1 - T_final, expected depth.

The per-tile work is the benchmark's batched ``kernels.composite_fwd`` and
``kernels.composite_bwd``.  ``composite_backward`` turns image, alpha and
depth cotangents into per-Gaussian gradients in the three modes of the JAX
backward, and ``slots_to_gaussians`` sums each Gaussian's slot rows.
``composite_tiles`` is differentiable: its autograd backward runs the
backward kernel in ``full`` mode when the caller passed the zero ``xy_abs``
input (whose gradient is the AbsGS |dL/dxy|), ``noabs`` otherwise.
``composite_tiles_sel`` also runs it in ``selonly`` mode against the
image-MSE cotangent inside its forward to give the AbsGS selection
gradients; its own backward is ``noabs``.  Both backwards reuse the forward
kernel's output rows and the packed table: no second forward launch.
"""

from __future__ import annotations

import torch

from .kernels import composite_bwd, composite_fwd


def pack_table(xy, conic, color, opacity, depth, valid=None) -> torch.Tensor:
    """Per-Gaussian (N, 12) attribute table in the kernel's row layout
    [x, y, a, b, c, opacity, r, g, b, depth, valid, 0]."""
    N = xy.shape[0]
    f = lambda v: v.to(torch.float32)
    val = xy.new_ones((N,)) if valid is None else f(valid)
    return torch.cat(
        [f(xy), f(conic), f(opacity)[:, None], f(color), f(depth)[:, None],
         val[:, None], xy.new_zeros((N, 1))],
        dim=-1,
    ).contiguous()


def _untile(x, tiles_x, tiles_y, ts, ch):
    """(num_tiles, ts², ch) -> (H, W, ch)."""
    x = x.reshape(tiles_y, tiles_x, ts, ts, ch)
    return x.permute(0, 2, 1, 3, 4).reshape(tiles_y * ts, tiles_x * ts, ch)


def _tile(img, tiles_x, tiles_y, ts):
    """(H, W, ch) -> (num_tiles, ts², ch)."""
    ch = img.shape[-1]
    x = img.reshape(tiles_y, ts, tiles_x, ts, ch)
    return x.permute(0, 2, 1, 3, 4).reshape(tiles_y * tiles_x, ts * ts, ch)


def _images(out, bg, tiles_x, tiles_y, ts):
    """Forward kernel rows (T, 5, ts²) -> image (with T_final·bg), alpha and
    depth at tile-padded size."""
    C = out[:, 0:3].transpose(1, 2)                         # (T, ts², 3)
    D = out[:, 3]
    alpha = out[:, 4]
    image_t = C + (1.0 - alpha)[..., None] * bg.to(torch.float32)
    return (
        _untile(image_t, tiles_x, tiles_y, ts, 3),
        _untile(alpha[..., None], tiles_x, tiles_y, ts, 1)[..., 0],
        _untile(D[..., None], tiles_x, tiles_y, ts, 1)[..., 0],
    )


class CompositeTiles(torch.autograd.Function):
    """``composite_tiles``: the forward kernel, and the backward kernel in
    ``full`` (with ``xy_abs``) or ``noabs`` mode as its autograd backward."""

    @staticmethod
    def forward(ctx, xy, xy_abs, conic, color, opacity, depth, bg, bins, dims,
                valid):
        pos = xy if xy_abs is None else xy + xy_abs
        table = pack_table(pos, conic, color, opacity, depth, valid)
        sorted_ids, _, _, tile_starts, tile_counts, _ = bins
        out = composite_fwd(table, sorted_ids, tile_starts, tile_counts, *dims)
        ctx.save_for_backward(table, out, bg)
        ctx.bins, ctx.dims, ctx.want_abs = bins, dims, xy_abs is not None
        return _images(out, bg, *dims)

    @staticmethod
    def backward(ctx, g_img, g_alpha, g_dep):
        table, out, bg = ctx.saved_tensors
        mode = "full" if ctx.want_abs else "noabs"
        d_xy, d_abs, d_con, d_col, d_opa, d_dep, d_bg = composite_backward(
            table, out, bg, _cotangents(out, ctx.dims, g_img, g_alpha, g_dep),
            ctx.bins, ctx.dims, mode)
        return (d_xy, d_abs if ctx.want_abs else None, d_con, d_col, d_opa,
                d_dep, d_bg, None, None, None)


def _cotangents(out, dims, g_img, g_alpha, g_dep):
    """The three image cotangents at tile-padded size, zeros for an output
    that received none."""
    tiles_x, tiles_y, ts = dims
    H, W = tiles_y * ts, tiles_x * ts
    z = lambda g, *c: out.new_zeros((H, W, *c)) if g is None else g.contiguous()
    return z(g_img, 3), z(g_alpha), z(g_dep)


def composite_tiles(xy, conic, color, opacity, depth, bg, bins, dims,
                    valid=None, xy_abs=None):
    """Composite N projected Gaussians into an image (differentiable).

    Args:
      xy, conic, color, opacity, depth: per-Gaussian (N, ...) tensors.
      bg: (3,) background color.
      bins: (sorted_ids, sorted_o, depth_order, tile_starts, tile_counts,
        n_slots) — the ``TileBins`` arrays, counts already clamped to the
        per-tile cap, and the slot-major extent N·max_tiles of ``sorted_o``.
      dims: (tiles_x, tiles_y, tile_size).
      valid: optional (N,) bool; a slot of an invalid Gaussian is skipped.
      xy_abs: optional (N, 2) zeros added to ``xy``; its gradient is the
        AbsGS |dL/dxy| (the backward kernel's ``full`` mode).  Without it
        the backward runs ``noabs``.
    Returns:
      image (H', W', 3), alpha (H', W'), depth (H', W') at tile-padded size.
    """
    return CompositeTiles.apply(xy, xy_abs, conic, color, opacity, depth, bg,
                                bins, dims, valid)


# ---------------------------------------------------------------------------
# backward (per-Gaussian gradients from image / alpha / depth cotangents)
# ---------------------------------------------------------------------------


def mse_image_cotangent(image, gt):
    """d/d image of mean((clip(image)[:H,:W] - gt)^2) at tile-padded
    resolution; clip passes gradient on [0, 1] inclusive (a white
    background puts many pixels at exactly 1.0)."""
    H, W = gt.shape[:2]
    img = image[:H, :W]
    inside = (img >= 0.0) & (img <= 1.0)
    cot_img = torch.where(inside, (2.0 / (H * W * 3)) * (img.clamp(0.0, 1.0) - gt),
                          torch.zeros_like(img))
    cot = torch.zeros_like(image)
    cot[:H, :W] = cot_img
    return cot


def _bwd_common(out, bg, cot, tiles_x, tiles_y, ts):
    """Backward preamble: the tiled cotangent rows gc4 (T, 4, ts²) = [gC,
    gD], G2 = G + dL/dT_fin (T, ts²) with G = gC·C_fin + gD·D_fin, and
    d_bg.  T_fin is 1 - alpha of the forward kernel's output rows."""
    gC_img, gA_img, gD_img = cot
    gC = _tile(gC_img, tiles_x, tiles_y, ts)                  # (T, ts², 3)
    gA = _tile(gA_img[..., None], tiles_x, tiles_y, ts)[..., 0]
    gD = _tile(gD_img[..., None], tiles_x, tiles_y, ts)[..., 0]
    C_fin = out[:, 0:3].transpose(1, 2)
    D_fin = out[:, 3]
    T_fin = 1.0 - out[:, 4]
    G = (gC * C_fin).sum(-1) + gD * D_fin
    gTf = ((gC * bg.to(torch.float32)).sum(-1) - gA) * T_fin
    d_bg = torch.einsum("tpc,tp->c", gC, T_fin)
    gc4 = torch.cat([gC.transpose(1, 2), gD[:, None]], dim=1).contiguous()
    return gc4, (G + gTf).contiguous(), d_bg


def slots_to_gaussians(slot_rows, sorted_o, depth_order, n_slots: int):
    """Per-slot rows (P, w) -> per-Gaussian sums (N, w): each Gaussian's D
    slot rows (``sorted_o`` holds the slot-major slot ``d·N + n`` of every
    sorted slot; slots past a pair budget stay zero), summed in f64."""
    P, w = slot_rows.shape
    N = depth_order.shape[0]
    D = n_slots // N
    per_slot = slot_rows.new_zeros((n_slots, w), dtype=torch.float64)
    per_slot[sorted_o.long()] = slot_rows.to(torch.float64)
    return per_slot.reshape(D, N, w).sum(0).to(slot_rows.dtype)


def composite_backward(table, out, bg, cot, bins, dims, mode: str = "full"):
    """Per-Gaussian compositing gradients from the forward kernel's output
    rows ``out`` and the (image, alpha, depth) cotangents ``cot`` at
    tile-padded size; ``bins`` and ``dims`` as ``composite_tiles`` takes
    them.

    Returns ``(d_xy, d_abs, d_conic, d_color, d_opacity, d_depth, d_bg)``
    as the JAX backward does; ``d_abs`` holds the AbsGS |dL/dx|, |dL/dy|
    sums.  Rows a mode does not compute come back as zeros (``noabs``:
    d_abs; ``selonly``: everything but d_abs)."""
    sorted_ids, sorted_o, depth_order, tile_starts, tile_counts, n_slots = bins
    gc4, G2, d_bg = _bwd_common(out, bg, cot, *dims)
    rows = composite_bwd(table, sorted_ids, tile_starts, tile_counts, gc4, G2,
                         *dims, mode)
    g = slots_to_gaussians(rows, sorted_o, depth_order, n_slots)
    grads = g.new_zeros((g.shape[0], 12))
    lo = 10 if mode == "selonly" else 0
    grads[:, lo:lo + g.shape[1]] = g
    return (grads[:, 0:2], grads[:, 10:12], grads[:, 2:5], grads[:, 6:9],
            grads[:, 5], grads[:, 9], d_bg)


class CompositeTilesSel(torch.autograd.Function):
    """``composite_tiles_sel``: the forward kernel and one ``selonly``
    backward launch in the forward; the ``noabs`` backward as its autograd
    backward (zero gradients for ``gt`` and ``sel_abs``)."""

    @staticmethod
    def forward(ctx, xy, conic, color, opacity, depth, bg, gt, bins, dims,
                valid):
        table = pack_table(xy, conic, color, opacity, depth, valid)
        sorted_ids, _, _, tile_starts, tile_counts, _ = bins
        out = composite_fwd(table, sorted_ids, tile_starts, tile_counts, *dims)
        image, alpha, dep = _images(out, bg, *dims)
        cot = (mse_image_cotangent(image, gt.to(torch.float32)),
               torch.zeros_like(alpha), torch.zeros_like(dep))
        sel_abs = composite_backward(table, out, bg, cot, bins, dims,
                                     "selonly")[1]
        ctx.mark_non_differentiable(sel_abs)
        ctx.save_for_backward(table, out, bg)
        ctx.bins, ctx.dims = bins, dims
        return image, alpha, dep, sel_abs

    @staticmethod
    def backward(ctx, g_img, g_alpha, g_dep, _g_sel):
        table, out, bg = ctx.saved_tensors
        d_xy, _, d_con, d_col, d_opa, d_dep, d_bg = composite_backward(
            table, out, bg, _cotangents(out, ctx.dims, g_img, g_alpha, g_dep),
            ctx.bins, ctx.dims, "noabs")
        return d_xy, d_con, d_col, d_opa, d_dep, d_bg, None, None, None, None


def composite_tiles_sel(xy, conic, color, opacity, depth, bg, gt, bins, dims,
                        valid=None):
    """``composite_tiles`` that also emits the AbsGS selection gradients.

    Returns ``(image, alpha, depth, sel_abs)``: ``sel_abs`` (N, 2) is the
    absolute screen gradient of the image MSE against ``gt`` (H, W, 3), the
    reference's ``means2D.grad[:, 2:4]``, from one ``selonly`` application
    of the backward kernel to the forward's own output rows (no second
    render); ``sel_abs`` carries no gradient.  ``bins`` and ``dims`` as
    ``composite_tiles`` takes them."""
    return CompositeTilesSel.apply(xy, conic, color, opacity, depth, bg, gt,
                                   bins, dims, valid)

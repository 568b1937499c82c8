"""Front-to-back alpha compositing over per-tile depth-ordered segments.

Port of ``generativedensification_tpu/splat/composite.py`` (semantics pinned
to the 3DGS CUDA rasterizer):
  * power = -0.5 (a dx² + c dy²) - b dx dy, clamped at 0,
  * alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255,
  * a pixel stops before the Gaussian that would drop its transmittance
    below 1e-4,
  * outputs: color (+ T_final·bg), alpha map 1 - T_final, expected depth.

The per-tile work is ``kernels.composite_fwd`` and ``kernels.composite_bwd``
(the CUDA kernels for tensors on the card, their plain versions for CPU
tensors).  ``composite_backward`` turns image, alpha and depth cotangents
into per-Gaussian gradients in the three modes of the JAX backward;
``composite_tiles_sel`` runs it in ``selonly`` mode against the image-MSE
cotangent to give the AbsGS selection gradients of the serving path.  The
autograd wiring of ``composite_tiles`` (``full`` / ``noabs`` behind
``CompositeTiles.backward``) belongs to the train step, ROADMAP slice 4.
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
    """``composite_tiles`` forward; its autograd backward is not wired yet."""

    @staticmethod
    def forward(ctx, xy, conic, color, opacity, depth, bg, sorted_ids,
                tile_starts, tile_counts, tiles_x, tiles_y, tile_size, valid):
        table = pack_table(xy, conic, color, opacity, depth, valid)
        out = composite_fwd(table, sorted_ids, tile_starts, tile_counts,
                            tiles_x, tiles_y, tile_size)       # (T, 5, ts²)
        return _images(out, bg, tiles_x, tiles_y, tile_size)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "composite_tiles has no autograd backward yet: the compositing "
            "gradient (kernel composite_bwd, modes full / noabs) is wired "
            "into autograd with the train step, ROADMAP slice 4"
        )


def composite_tiles(xy, conic, color, opacity, depth, bg, sorted_ids,
                    tile_starts, tile_counts, tiles_x: int, tiles_y: int,
                    tile_size: int, valid=None):
    """Composite N projected Gaussians into an image.

    Args:
      xy, conic, color, opacity, depth: per-Gaussian (N, ...) tensors.
      bg: (3,) background color.
      sorted_ids, tile_starts, tile_counts: the ``TileBins`` segment arrays,
        counts already clamped to the per-tile cap.
      valid: optional (N,) bool; a slot of an invalid Gaussian is skipped.
    Returns:
      image (H', W', 3), alpha (H', W'), depth (H', W') at tile-padded size.
    """
    return CompositeTiles.apply(xy, conic, color, opacity, depth, bg,
                                sorted_ids, tile_starts, tile_counts,
                                tiles_x, tiles_y, tile_size, valid)


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


def slots_to_gaussians(slot_rows, sorted_o, n_gauss: int, n_slots: int):
    """Per-slot rows (P, w) -> per-Gaussian sums (N, w).

    ``sorted_o`` holds the slot-major original slot ``d·N + n`` of every
    sorted slot.  Its inverse, built by a scatter onto a zero sentinel row
    (P) so that a pair budget (P < N·D) leaves the dropped slots at zero,
    gathers each Gaussian's D slot rows, which are then summed over d in
    order: the same sums in the same order on every run."""
    P, w = slot_rows.shape
    ext = torch.cat([slot_rows, slot_rows.new_zeros((1, w))])
    inv = torch.full((n_slots,), P, dtype=torch.long, device=slot_rows.device)
    inv[sorted_o.long()] = torch.arange(P, device=slot_rows.device)
    per_d = ext[inv].reshape(n_slots // n_gauss, n_gauss, w)
    acc = per_d[0]
    for d in range(1, per_d.shape[0]):
        acc = acc + per_d[d]
    return acc


def composite_backward(table, out, bg, cot, sorted_ids, sorted_o, tile_starts,
                       tile_counts, tiles_x: int, tiles_y: int, tile_size: int,
                       n_slots: int, mode: str = "full"):
    """Per-Gaussian compositing gradients from the forward kernel's output
    rows ``out`` and the (image, alpha, depth) cotangents ``cot`` at
    tile-padded size.

    Returns ``(d_xy, d_abs, d_conic, d_color, d_opacity, d_depth, d_bg)``
    as the JAX backward does; ``d_abs`` holds the AbsGS |dL/dx|, |dL/dy|
    sums.  Rows a mode does not compute come back as zeros (``noabs``:
    d_abs; ``selonly``: everything but d_abs)."""
    gc4, G2, d_bg = _bwd_common(out, bg, cot, tiles_x, tiles_y, tile_size)
    rows = composite_bwd(table, sorted_ids, tile_starts, tile_counts, gc4, G2,
                         tiles_x, tiles_y, tile_size, mode)
    g = slots_to_gaussians(rows, sorted_o, table.shape[0], n_slots)
    grads = g.new_zeros((g.shape[0], 12))
    lo = 10 if mode == "selonly" else 0
    grads[:, lo:lo + g.shape[1]] = g
    return (grads[:, 0:2], grads[:, 10:12], grads[:, 2:5], grads[:, 6:9],
            grads[:, 5], grads[:, 9], d_bg)


class CompositeTilesSel(torch.autograd.Function):
    """``composite_tiles_sel`` forward; its autograd backward (the ``noabs``
    gradient of the image outputs) is not wired yet."""

    @staticmethod
    def forward(ctx, xy, conic, color, opacity, depth, bg, gt, sorted_ids,
                sorted_o, tile_starts, tile_counts, tiles_x, tiles_y,
                tile_size, valid, n_slots):
        table = pack_table(xy, conic, color, opacity, depth, valid)
        out = composite_fwd(table, sorted_ids, tile_starts, tile_counts,
                            tiles_x, tiles_y, tile_size)
        image, alpha, dep = _images(out, bg, tiles_x, tiles_y, tile_size)
        cot = (mse_image_cotangent(image, gt.to(torch.float32)),
               torch.zeros_like(alpha), torch.zeros_like(dep))
        sel_abs = composite_backward(
            table, out, bg, cot, sorted_ids, sorted_o, tile_starts,
            tile_counts, tiles_x, tiles_y, tile_size, n_slots, "selonly")[1]
        ctx.mark_non_differentiable(sel_abs)
        return image, alpha, dep, sel_abs

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "composite_tiles_sel has no autograd backward yet: it arrives "
            "with the train step, ROADMAP slice 4"
        )


def composite_tiles_sel(xy, conic, color, opacity, depth, bg, gt, sorted_ids,
                        sorted_o, tile_starts, tile_counts, tiles_x: int,
                        tiles_y: int, tile_size: int, valid=None,
                        n_slots: int = 0):
    """``composite_tiles`` that also emits the AbsGS selection gradients.

    Returns ``(image, alpha, depth, sel_abs)``: ``sel_abs`` (N, 2) is the
    absolute screen gradient of the image MSE against ``gt`` (H, W, 3), the
    reference's ``means2D.grad[:, 2:4]``, from one ``selonly`` application
    of the backward kernel to the forward's own output rows (no second
    render).  ``n_slots`` is the slot-major extent N·max_tiles of
    ``sorted_o`` (0: the number of sorted slots)."""
    return CompositeTilesSel.apply(
        xy, conic, color, opacity, depth, bg, gt, sorted_ids, sorted_o,
        tile_starts, tile_counts, tiles_x, tiles_y, tile_size, valid,
        n_slots or sorted_ids.shape[0])

"""Front-to-back alpha compositing over per-tile depth-ordered segments.

Port of the forward of ``generativedensification_tpu/splat/composite.py``
``composite_tiles`` (semantics pinned to the 3DGS CUDA rasterizer):
  * power = -0.5 (a dx² + c dy²) - b dx dy, clamped at 0,
  * alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255,
  * a pixel stops before the Gaussian that would drop its transmittance
    below 1e-4,
  * outputs: color (+ T_final·bg), alpha map 1 - T_final, expected depth.

The per-tile work is ``kernels.composite_fwd`` (the CUDA kernel for tensors
on the card, its plain version for CPU tensors).  The backward — the
hand-written compositing gradient, TPU kernel ``pallas_composite_bwd`` —
arrives with ROADMAP slice 2; until then the function is forward-only and
the slice runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import torch

from .kernels import composite_fwd


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


class CompositeTiles(torch.autograd.Function):
    """``composite_tiles`` forward; the backward is not ported yet."""

    @staticmethod
    def forward(ctx, xy, conic, color, opacity, depth, bg, sorted_ids,
                tile_starts, tile_counts, tiles_x, tiles_y, tile_size, valid):
        table = pack_table(xy, conic, color, opacity, depth, valid)
        out = composite_fwd(table, sorted_ids, tile_starts, tile_counts,
                            tiles_x, tiles_y, tile_size)       # (T, 5, ts²)
        C = out[:, 0:3].transpose(1, 2)                         # (T, ts², 3)
        D = out[:, 3]
        alpha = out[:, 4]
        image_t = C + (1.0 - alpha)[..., None] * bg.to(torch.float32)
        return (
            _untile(image_t, tiles_x, tiles_y, tile_size, 3),
            _untile(alpha[..., None], tiles_x, tiles_y, tile_size, 1)[..., 0],
            _untile(D[..., None], tiles_x, tiles_y, tile_size, 1)[..., 0],
        )

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "composite_tiles has no backward yet: the compositing gradient "
            "(TPU kernel pallas_composite_bwd) arrives with ROADMAP slice 2"
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

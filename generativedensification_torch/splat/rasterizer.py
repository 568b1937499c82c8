"""Public splatting API (3DGS path), PyTorch.

Port of ``generativedensification_tpu/splat/rasterizer.py``: image
(H, W, 3), alpha map, expected depth and per-Gaussian radii, differentiable
through autograd.  Tensors on the card are projected, binned and composited
by the CUDA kernels (``projection.project``, ``binning.bin_and_cap``, the
compositors), CPU tensors by their plain versions; there is no backend
switch.
``screen_offset`` / ``screen_abs`` are the AbsGS gradient hooks of the
reference's zero ``means2D`` tensor: ``screen_offset`` is added to the
projected means (its gradient is the signed screen gradient) and
``screen_abs`` is the zero ``xy_abs`` input of ``composite_tiles`` (its
gradient is the absolute one, from the backward kernel's ``full`` mode).
``sel_gt`` gives the fused AbsGS selection gradients of one forward
(``composite_tiles_sel``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import tracing
from .binning import bin_and_cap
from .composite import composite_tiles, composite_tiles_sel
from .projection import project


@dataclasses.dataclass
class RasterizeOutput:
    image: torch.Tensor      # (H, W, 3) in [0, 1] (clamped)
    alpha: torch.Tensor      # (H, W)
    depth: torch.Tensor      # (H, W) expected depth (Σ z·α·T)
    radii: torch.Tensor      # (N,) screen radius in pixels (0 = culled)
    overflow: torch.Tensor   # () binning + per-tile cap overflow
    sel_abs: torch.Tensor | None = None  # (N, 2) AbsGS selection grads
                                         # (only with rasterize(sel_gt=...))


@tracing.traced("gd.render")
def rasterize(means3d, shs, opacities, scales, rotations, camera, bg,
              sh_degree: int, tile_size: int = 32, max_tiles: int = 16,
              max_per_tile: int = 4096, max_pairs: int | None = None,
              enum_tiles: int | None = None,
              sel_gt: torch.Tensor | None = None,
              screen_offset: torch.Tensor | None = None,
              screen_abs: torch.Tensor | None = None) -> RasterizeOutput:
    """Splat N activated Gaussians into one camera.

    means3d (N, 3); shs (N, (d+1)², 3); opacities (N,) sigmoid-activated;
    scales (N, 3) exp-activated; rotations (N, 4) quaternions (normalized
    here); camera a ``core.Camera``; bg (3,).  ``max_pairs`` is the optional
    static live-pair budget (dropped pairs count in ``overflow``).
    ``sel_gt`` (H, W, 3): the output also carries ``sel_abs``, the AbsGS
    selection gradients of the image MSE against it, from the same forward.
    ``screen_offset`` / ``screen_abs`` (N, 2) zeros: their gradients are the
    signed / absolute screen-space gradients (``screen_abs`` is ignored
    with ``sel_gt``, as in the JAX function).
    """
    N = means3d.shape[0]
    H, W = camera.height, camera.width
    max_per_tile = min(max_per_tile, N * max_tiles)

    with tracing.span("gd.project"):
        proj, opacity_eff = project(means3d, shs, opacities, camera, sh_degree,
                                    scales, rotations, screen_offset)
    with tracing.span("gd.bin"):
        bins, tile_counts, overflow = bin_and_cap(
            proj, H, W, tile_size, max_tiles, max_per_tile, max_pairs, enum_tiles)
    seg = (bins.sorted_ids, bins.sorted_o, bins.depth_order, bins.tile_starts,
           tile_counts, N * max_tiles)
    dims = (bins.tiles_x, bins.tiles_y, tile_size)
    attrs = (proj.xy, proj.conic, proj.color, opacity_eff, proj.depth,
             bg.to(torch.float32))
    sel_abs = None
    if sel_gt is not None:
        image, alpha, depth, sel_abs = composite_tiles_sel(
            *attrs, sel_gt, seg, dims, proj.valid)
    else:
        image, alpha, depth = composite_tiles(*attrs, seg, dims, proj.valid,
                                              screen_abs)
    return RasterizeOutput(
        image=torch.clamp(image[:H, :W], 0.0, 1.0),
        alpha=alpha[:H, :W],
        depth=depth[:H, :W],
        radii=proj.radius,
        overflow=overflow,
        sel_abs=sel_abs,
    )


def render_view(means3d, shs, opacity_raw, scale_raw, rotation_raw, camera,
                bg, sh_degree: int = 1, scale_shift: float = 0.0,
                opacity_shift: float = 0.0, **kw) -> RasterizeOutput:
    """Raw-parameter entry: scale = exp(raw + shift), opacity =
    sigmoid(raw + shift), rotation = normalize(raw), then splat."""
    return rasterize(
        means3d, shs, torch.sigmoid(opacity_raw + opacity_shift),
        torch.exp(scale_raw + scale_shift), rotation_raw, camera, bg,
        sh_degree, **kw,
    )


class Renderer:
    """Object-style wrapper mirroring the reference ``Renderer`` surface:
    ``render_img`` returns the ``{image, depth, acc_map, radii}`` dict (with
    an optional key suffix ``prex`` for the fine stage)."""

    def __init__(self, sh_degree: int = 1, white_background: bool = True,
                 radius: float = 1.0, device=None):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.sh_degree = sh_degree
        self.white_background = white_background
        self.radius = radius
        self.bg_color = (torch.ones(3) if white_background
                         else torch.zeros(3)).to(self.device)

    def render_img(self, cam, rays, centers, shs, opacity, scales, rotations,
                   bg_color=None, prex: str = "", **kw) -> dict:
        """Activated-attribute render; returns the reference's output dict."""
        del rays  # accepted for API parity; unused by the 3DGS path
        bg = self.bg_color if bg_color is None else torch.as_tensor(
            bg_color, dtype=torch.float32, device=self.device)
        out = rasterize(
            centers, shs.reshape(shs.shape[0], -1, 3), opacity.reshape(-1),
            scales, rotations, cam, bg, self.sh_degree, **kw,
        )
        return {
            f"image{prex}": out.image,
            f"depth{prex}": out.depth[..., None],
            f"acc_map{prex}": out.alpha,
            f"radii{prex}": out.radii,
        }

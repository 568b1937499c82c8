"""Tile binning: map projected Gaussians to depth-ordered per-tile segments.

Port of ``generativedensification_tpu/splat/binning.py``, same static
budget semantics so the same projected inputs give the same integer arrays:
  * every Gaussian owns ``max_tiles`` slots; slot ``d`` enumerates the tiles
    of its screen bounding rect in row-major order (optionally ``enum_tiles``
    rect tiles compacted into the budget), culled by a safe analytic
    max-alpha bound over each tile,
  * the sort key packs ``tile_id * N_pow2 + depth_rank`` into one int32,
    the depth rank coming from one STABLE global depth argsort, so each
    tile's segment is front-to-back,
  * segment starts come from ``searchsorted`` over the sorted tile ids,
  * dropped (gaussian, tile) pairs are counted in ``overflow``.

``bin_gaussians_plain`` is the op chain.  ``bin_and_cap`` is the entry: it
runs the chain for CPU tensors and, for tensors on the card, the pre-pass
kernels of ``csrc/prepass.cu`` (``depth_rank``, ``tile_keys``,
``tile_ranges``: they replace no TPU kernel; XLA fuses the chain there,
eager PyTorch launched ~100 ops a view) around the same two stable library
sorts: the same integer arrays, bit for bit.  It also clamps the tile counts
to the per-tile cap and totals the overflow, which on the card the last
kernel does.  ``bin_gaussians`` is ``bin_and_cap`` with no cap.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import tracing
from .kernels import MAIN_KERNELS, build, launch_counts
from .projection import ProjectedGaussians

DEAD_KEY = 2**31 - 1
NO_CAP = 2**31 - 1      # a per-tile cap that clamps nothing


@dataclasses.dataclass
class TileBins:
    """Depth-ordered tile segments for one view."""

    sorted_ids: torch.Tensor    # (P,) gaussian index per sorted slot
    sorted_o: torch.Tensor      # (P,) slot-major original slot d * N + n
    sorted_valid: torch.Tensor  # (P,) bool, live slot
    sorted_rank: torch.Tensor   # (P,) global depth rank per sorted slot
    depth_order: torch.Tensor   # (N,) depth rank -> gaussian index
    tile_starts: torch.Tensor   # (num_tiles,) first sorted slot of each tile
    tile_counts: torch.Tensor   # (num_tiles,) live slots per tile
    overflow: torch.Tensor      # () int32 — pairs dropped by the budgets
    tiles_x: int = 0
    tiles_y: int = 0
    tile_size: int = 32


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _grid(N: int, height: int, width: int, tile_size: int) -> tuple:
    """(tiles_x, tiles_y, num_tiles, N_pow2); raises where the int32 key
    would overflow."""
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    n_pow2 = _next_pow2(N)
    if tiles_x * tiles_y * n_pow2 >= 2**31:
        raise ValueError("int32 key overflow; shrink tiles or N")
    return tiles_x, tiles_y, tiles_x * tiles_y, n_pow2


def bin_gaussians(proj: ProjectedGaussians, height: int, width: int,
                  tile_size: int = 32, max_tiles: int = 16,
                  max_pairs: int | None = None,
                  enum_tiles: int | None = None) -> TileBins:
    """Bin one view's projected Gaussians into per-tile depth-ordered
    segments: ``bin_and_cap``'s bins with no per-tile cap."""
    return bin_and_cap(proj, height, width, tile_size, max_tiles, NO_CAP,
                       max_pairs, enum_tiles)[0]


def bin_and_cap(proj: ProjectedGaussians, height: int, width: int,
                tile_size: int, max_tiles: int, max_per_tile: int,
                max_pairs: int | None = None,
                enum_tiles: int | None = None) -> tuple:
    """The renderers' binning of one view: (bins, the tile counts clamped
    to ``max_per_tile``, the overflow of the budgets and the cap together).
    The per-tile slot cap is a shared semantic: the counts are clamped once,
    so that every path composites the same front-most ``max_per_tile``
    slots of each tile, and the truncation counts in the overflow.  Counts
    ``pairs`` (the clamped counts) and ``pairs_dropped`` (that overflow),
    and ``prepass_kernel_views`` where the kernels binned."""
    if proj.xy.device.type == "cpu":
        bins = bin_gaussians_plain(proj, height, width, tile_size, max_tiles,
                                   max_pairs, enum_tiles)
        tile_counts = torch.clamp(bins.tile_counts, max=max_per_tile)
        cap_overflow = (bins.tile_counts - tile_counts).sum().to(torch.int32)
        overflow = bins.overflow + cap_overflow
    else:
        bins, tile_counts, overflow = _bin_kernels(
            proj, height, width, tile_size, max_tiles, max_pairs, enum_tiles,
            max_per_tile)
        tracing.count("prepass_kernel_views", 1)
    tracing.count("pairs", tile_counts)
    tracing.count("pairs_dropped", overflow)
    return bins, tile_counts, overflow


def _bin_kernels(proj: ProjectedGaussians, height: int, width: int,
                 tile_size: int, max_tiles: int, max_pairs: int | None,
                 enum_tiles: int | None, max_per_tile: int) -> tuple:
    """``bin_gaussians_plain`` on the card: (TileBins, the counts clamped to
    ``max_per_tile``, binning + cap overflow).  Launches ``depth_rank``,
    ``tile_keys`` and ``tile_ranges`` once each around the chain's two
    stable sorts (the depth sort's key, depth where valid else +inf, one
    elementwise op); the ``max_pairs`` budget keeps the chain's rank-ordered
    cumsum between ``tile_keys`` and the key sort.  Reads nothing back."""
    i32, f32 = torch.int32, torch.float32
    dev = proj.xy.device
    if dev.type != "cuda":
        raise ValueError(f"the binning kernels: unsupported device {dev}")
    N = proj.xy.shape[0]
    tiles_x, tiles_y, num_tiles, n_pow2 = _grid(N, height, width, tile_size)
    E = max_tiles if enum_tiles is None else max(enum_tiles, max_tiles)
    f = lambda t: t.detach().to(f32).contiguous()
    xy, radius, conic, opacity = f(proj.xy), f(proj.radius), f(proj.conic), f(proj.opacity)
    valid = proj.valid.contiguous()
    depth_key = torch.where(valid, proj.depth.detach().to(f32), float("inf"))
    lib = build(MAIN_KERNELS)["prepass"].lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    e = lambda shape, dtype=i32: torch.empty(shape, dtype=dtype, device=dev)

    def launch(name, *args):
        with torch.cuda.device(dev):
            err = getattr(lib, f"gd_{name}")(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        launch_counts[name] += 1

    # global front-to-back rank (culled last) from the chain's STABLE sort;
    # counters: [0] the binning overflow, [1] tile_ranges' finished blocks
    order64 = torch.sort(depth_key, stable=True).indices
    order, rank, counters = e(N), e(N), e(2, torch.int64)
    launch("depth_rank", order64.data_ptr(), order.data_ptr(), rank.data_ptr(), N,
           counters.data_ptr())

    keys = e((max_tiles, N))
    pairs_budget = max_pairs is not None and max_pairs < N * max_tiles
    n_slots = e(N) if pairs_budget else None
    if N:
        launch("tile_keys", xy.data_ptr(), radius.data_ptr(), conic.data_ptr(),
               opacity.data_ptr(), valid.data_ptr(), rank.data_ptr(), keys.data_ptr(),
               None if n_slots is None else n_slots.data_ptr(), counters.data_ptr(),
               N, tiles_x, tiles_y, tile_size, max_tiles, E, n_pow2)
    if pairs_budget:
        # drop the pairs of the globally farthest gaussians first
        P = min(-(-int(max_pairs) // 1024) * 1024, N * max_tiles)
        per_rank = n_slots[order.long()]
        keep_rank = torch.cumsum(per_rank, 0) <= P
        kept = torch.where(keep_rank, per_rank, torch.zeros_like(per_rank)).sum()
        counters[0].add_(n_slots.sum() - kept)
        keys = torch.where(keep_rank[rank.long()][None, :], keys, DEAD_KEY)
    else:
        P = N * max_tiles

    # stable: live keys are unique; dead slots keep slot order
    sorted_keys, perm = torch.sort(keys.reshape(-1), stable=True)
    sorted_ids, sorted_o, sorted_rank = e(P), e(P), e(P)
    sorted_valid = e(P, torch.bool)
    starts, counts, capped = e(num_tiles + 1), e(num_tiles), e(num_tiles)
    overflow, overflow_total = e(()), e(())
    launch("tile_ranges", sorted_keys.data_ptr(), perm.data_ptr(), sorted_ids.data_ptr(),
           sorted_o.data_ptr(), sorted_rank.data_ptr(), sorted_valid.data_ptr(),
           starts.data_ptr(), counts.data_ptr(), capped.data_ptr(), overflow.data_ptr(),
           overflow_total.data_ptr(), counters.data_ptr(), P, N, n_pow2, num_tiles,
           max_per_tile)
    bins = TileBins(
        sorted_ids=sorted_ids,
        sorted_o=sorted_o,
        sorted_valid=sorted_valid,
        sorted_rank=sorted_rank,
        depth_order=order,
        tile_starts=starts[:num_tiles],
        tile_counts=counts,
        overflow=overflow,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        tile_size=tile_size,
    )
    return bins, capped, overflow_total


def bin_gaussians_plain(proj: ProjectedGaussians, height: int, width: int,
                        tile_size: int = 32, max_tiles: int = 16,
                        max_pairs: int | None = None,
                        enum_tiles: int | None = None) -> TileBins:
    """Bin one view's projected Gaussians into per-tile depth-ordered
    segments with the op chain (the JAX docstring carries the culling
    derivation)."""
    i32, f32 = torch.int32, torch.float32
    xy = proj.xy.detach()
    radius = proj.radius.detach()
    depth = proj.depth.detach()
    conic = proj.conic.detach()
    opacity = proj.opacity.detach()
    valid = proj.valid
    dev = xy.device

    N = xy.shape[0]
    tiles_x, tiles_y, num_tiles, n_pow2 = _grid(N, height, width, tile_size)

    # global front-to-back rank (invalid last); the depth sort is STABLE
    depth_key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices.to(i32)   # rank -> g
    iota = torch.arange(N, dtype=i32, device=dev)
    rank = torch.empty_like(iota)
    rank[order.long()] = iota                                    # g -> rank

    # screen rect in tile units (3DGS getRect semantics; int cast truncates)
    def tiles(v, n):
        return torch.clamp((v / tile_size).to(i32), 0, n)

    rmin_x = tiles(xy[:, 0] - radius, tiles_x)
    rmin_y = tiles(xy[:, 1] - radius, tiles_y)
    rmax_x = tiles(xy[:, 0] + radius + tile_size - 1, tiles_x)
    rmax_y = tiles(xy[:, 1] + radius + tile_size - 1, tiles_y)
    rect_w = torch.clamp(rmax_x - rmin_x, min=0)
    rect_h = torch.clamp(rmax_y - rmin_y, min=0)
    n_cover = torch.where(valid, rect_w * rect_h, torch.zeros_like(rect_w))

    # enumerate E >= D rect tiles, slot-major (E, N)
    E = max_tiles if enum_tiles is None else max(enum_tiles, max_tiles)
    e = torch.arange(E, dtype=i32, device=dev)[:, None]
    safe_w = torch.clamp(rect_w, min=1)[None, :]
    tile_x = rmin_x[None, :] + e % safe_w
    tile_y = rmin_y[None, :] + torch.div(e, safe_w, rounding_mode="floor")
    in_rect = (e < n_cover[None, :]) & valid[None, :]

    # SAFE max-alpha-over-tile bound (circle + major-eigvec directional)
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    m = 0.5 * (ca + cc)
    r = torch.sqrt(torch.clamp((0.5 * (ca - cc)) ** 2 + cb * cb, min=0.0))
    lam_min = torch.clamp(m - r, min=0.0)
    lam_max = m + r
    v1x, v1y = cb, lam_max - ca
    v2x, v2y = lam_max - cc, cb
    n1 = v1x * v1x + v1y * v1y
    n2 = v2x * v2x + v2y * v2y
    use1 = n1 >= n2
    ux = torch.where(use1, v1x, v2x)
    uy = torch.where(use1, v1y, v2y)
    un = torch.sqrt(torch.maximum(n1, n2))
    degen = un < 1e-20
    one = torch.ones_like(un)
    un_safe = torch.where(degen, one, un)
    ux = torch.where(degen, one, ux / un_safe)
    uy = torch.where(degen, torch.zeros_like(un), uy / un_safe)
    tau = torch.log(torch.clamp(opacity, min=1e-12) * 255.0)   # ALPHA_MIN

    half = (tile_size - 1) * 0.5
    tcx = tile_x.to(f32) * tile_size + half
    tcy = tile_y.to(f32) * tile_size + half
    cx = xy[None, :, 0] - tcx
    cy = xy[None, :, 1] - tcy
    dxr = torch.clamp(cx.abs() - half, min=0.0)
    dyr = torch.clamp(cy.abs() - half, min=0.0)
    bound = 0.5 * lam_min[None, :] * (dxr * dxr + dyr * dyr)
    du = torch.clamp(
        (cx * ux[None, :] + cy * uy[None, :]).abs()
        - half * (ux.abs() + uy.abs())[None, :],
        min=0.0,
    )
    bound = torch.maximum(bound, 0.5 * lam_max[None, :] * du * du)
    touch = in_rect & (bound <= tau[None, :])

    n_touch = touch.to(i32).sum(dim=0)
    if E == max_tiles:
        tile_id = tile_y * tiles_x + tile_x
        slot_valid = touch
    else:
        # stable compaction of touching tiles (keys unique per column)
        ckey = torch.where(touch, e.expand(E, N), E + e)
        ckey, perm = torch.sort(ckey, dim=0)
        tile_id = torch.gather(tile_y * tiles_x + tile_x, 0, perm)[:max_tiles]
        slot_valid = ckey[:max_tiles] < E
    overflow = (
        torch.clamp(n_touch - max_tiles, min=0).sum()
        + torch.clamp(n_cover - E, min=0).sum()
    ).to(i32)

    if max_pairs is not None and max_pairs < N * max_tiles:
        # drop the pairs of the globally farthest gaussians first
        P = min(-(-int(max_pairs) // 1024) * 1024, N * max_tiles)
        n_slots_g = slot_valid.to(i32).sum(dim=0)
        per_rank = n_slots_g[order.long()]
        keep_rank = torch.cumsum(per_rank, 0) <= P
        kept = torch.where(keep_rank, per_rank, torch.zeros_like(per_rank)).sum()
        overflow = (overflow + (n_slots_g.sum() - kept)).to(i32)
        slot_valid = slot_valid & keep_rank[rank.long()][None, :]
    else:
        P = N * max_tiles

    keys = torch.where(
        slot_valid, tile_id * n_pow2 + rank[None, :],
        torch.full_like(tile_id, DEAD_KEY),
    ).reshape(-1)                                   # d-major: o = d * N + n
    # stable: live keys are unique; dead slots keep slot order
    sorted_keys, sorted_o = torch.sort(keys, stable=True)
    sorted_keys = sorted_keys[:P]
    sorted_o = sorted_o[:P].to(i32)
    sorted_ids = torch.remainder(sorted_o, N)
    sorted_rank = torch.remainder(sorted_keys, n_pow2)
    sorted_valid = sorted_keys != DEAD_KEY
    sorted_tile = torch.where(
        sorted_valid, torch.div(sorted_keys, n_pow2, rounding_mode="floor"),
        torch.full_like(sorted_keys, num_tiles),
    )

    tile_range = torch.arange(num_tiles, dtype=i32, device=dev)
    tile_starts = torch.searchsorted(sorted_tile, tile_range).to(i32)
    tile_ends = torch.searchsorted(sorted_tile, tile_range, right=True).to(i32)
    return TileBins(
        sorted_ids=sorted_ids,
        sorted_o=sorted_o,
        sorted_valid=sorted_valid,
        sorted_rank=sorted_rank,
        depth_order=order,
        tile_starts=tile_starts,
        tile_counts=tile_ends - tile_starts,
        overflow=overflow,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        tile_size=tile_size,
    )

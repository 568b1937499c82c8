"""PointSet: dense batched point cloud with validity mask + serialization.

Port of ``generativedensification_tpu/points/structure.py``: ``(B, N, ...)``
tensors plus a ``(B, N)`` mask; :func:`serialize_pointset` computes the
space-filling-curve permutations of every requested order (invalid points
key past every valid one, so they sort to the tail of each sample).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..serialization import encode
from ..serialization.zorder import LO_BITS

MAX_DEPTH = 16
# the key of an invalid point: hi word 0xFFFFFFFF, its own lo word below it,
# as the JAX package sorts (hi = max, lo)
_INVALID_HI = 0xFFFFFFFF << LO_BITS


@dataclasses.dataclass
class PointSet:
    """A batch of fixed-budget point clouds.

    ``orders``/``inverses`` are ``(O, B, N)`` permutations per serialization
    order: ``feat[b, orders[o, b]]`` is sample ``b`` in curve order ``o``;
    ``inverses`` maps back."""

    coord: torch.Tensor                      # (B, N, 3) f32
    feat: torch.Tensor                       # (B, N, C)
    mask: torch.Tensor                       # (B, N) bool validity
    grid_size: float = 1.0
    orders: torch.Tensor | None = None       # (O, B, N) int64
    inverses: torch.Tensor | None = None     # (O, B, N) int64
    global_feat: torch.Tensor | None = None  # (B, C)
    attribute: torch.Tensor | None = None    # (B, N, A) residual-mode attrs
    prob: torch.Tensor | None = None         # (B, N) densification prob
    grid_coord: torch.Tensor | None = None   # (B, N, 3) int32
    neighbor_idx: torch.Tensor | None = None  # (B, N, 27) int64, -1 = absent
    condition: int = 0                       # PDNorm dataset-condition index

    def replace(self, **kw) -> "PointSet":
        return dataclasses.replace(self, **kw)


def depth_for_grid(grid_size: float, extent: float = 1.0, margin_bits: int = 1) -> int:
    """Static serialization depth for a scene of ``extent`` world units."""
    cells = max(2, int(math.ceil(extent / grid_size)) + 1)
    return min(MAX_DEPTH, cells.bit_length() + margin_bits)


def grid_quantize(coord: torch.Tensor, mask: torch.Tensor, grid_size: float) -> torch.Tensor:
    """Per-sample grid coords floor((coord - min_valid) / grid_size), the
    min taken over valid points only."""
    big = torch.full_like(coord, 1e30)
    cmin = torch.where(mask[..., None], coord, big).amin(dim=1, keepdim=True)
    gc = torch.floor((coord - cmin) / grid_size).to(torch.int32)
    return torch.clamp(gc, min=0)


def serialize_pointset(ps: PointSet, orders=("z", "z-trans", "hilbert", "hilbert-trans"),
                       depth: int | None = None) -> PointSet:
    """Per-order sort permutations (stable sort on the int64 key).  The
    train-time order shuffling arrives with ROADMAP slice 4."""
    if depth is None:
        depth = depth_for_grid(ps.grid_size)
    gc = grid_quantize(ps.coord, ps.mask, ps.grid_size)
    B, N = ps.mask.shape
    iota = torch.arange(N, device=gc.device).expand(B, N)
    perms, invs = [], []
    for order in orders:
        code = encode(gc, depth=depth, order=order)                # (B, N)
        lo = code & ((1 << LO_BITS) - 1)
        key = torch.where(ps.mask, code, lo | _INVALID_HI)
        perm = torch.sort(key, dim=1, stable=True).indices
        inv = torch.empty_like(perm).scatter_(1, perm, iota)
        perms.append(perm)
        invs.append(inv)
    return ps.replace(orders=torch.stack(perms), inverses=torch.stack(invs),
                      grid_coord=gc)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def gather_points(ps: PointSet, idx: torch.Tensor, new_mask: torch.Tensor | None = None) -> PointSet:
    """Gather a fixed-size subset idx (B, K); serialization permutations
    and the neighbor table are dropped, attributes and probs carried."""
    take = lambda a: None if a is None else gather_rows(a, idx)
    take1 = lambda a: None if a is None else torch.gather(a, 1, idx)
    return PointSet(
        coord=take(ps.coord),
        feat=take(ps.feat),
        mask=take1(ps.mask) if new_mask is None else new_mask,
        grid_size=ps.grid_size,
        global_feat=ps.global_feat,
        attribute=take(ps.attribute),
        prob=take1(ps.prob),
        grid_coord=take(ps.grid_coord),
        condition=ps.condition,
    )


def _pack(g: torch.Tensor) -> torch.Tensor:
    """Grid coords -> the 30-bit voxel key, with uint32 wrap-around."""
    g = g.long() & 0xFFFFFFFF
    return (((g[..., 0] << 20) | (g[..., 1] << 10) | g[..., 2])) & 0xFFFFFFFF


def compute_neighbor_idx(ps: PointSet) -> PointSet:
    """3³ voxel-neighborhood index table for the submanifold-conv CPE:
    (B, N, 27) point index of each neighbor voxel, -1 for an empty voxel
    (and for every query of an invalid point).

    The 27·N query keys are resolved by ``searchsorted`` into the stably
    sorted point keys.  When several points share a voxel, the last of
    them in the stable order (the highest index) represents it.  The JAX
    package picks the last in an UNSTABLE sort's order, so the two may name
    different co-voxel representatives; every other entry is the same."""
    if ps.grid_coord is None:
        raise ValueError("call serialize_pointset first (needs grid_coord)")
    B, N = ps.mask.shape
    gc = ps.grid_coord.long() + 1          # headroom: -1 offsets stay >= 0
    key = torch.where(ps.mask, _pack(gc), torch.full_like(gc[..., 0], (1 << 30) - 1))
    r = torch.arange(-1, 2, device=gc.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)
    nbr_key = _pack(gc[:, :, None, :] + offs).reshape(B, N * 27)
    sorted_key, perm = torch.sort(key, dim=1, stable=True)
    pos = torch.searchsorted(sorted_key, nbr_key, right=True) - 1
    pos_c = pos.clamp(min=0)
    hit = (pos >= 0) & (torch.gather(sorted_key, 1, pos_c) == nbr_key)
    nbr = torch.where(hit, torch.gather(perm, 1, pos_c), torch.full_like(pos, -1))
    nbr = nbr.reshape(B, N, 27)
    nbr = torch.where(ps.mask[..., None], nbr, torch.full_like(nbr, -1))
    return ps.replace(neighbor_idx=nbr)

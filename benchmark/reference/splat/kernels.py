"""The plain reference compositors of the benchmark: 3DGS forward and
backward as batched tensor operations.

They take the kernels' inputs and give their outputs (the port's
``splat/kernels.py`` describes the layouts), with the same semantics: the
power form and alpha in f32 in the kernels' order of operations, the 1/255
cut, alpha clamped at 0.99, and a pixel that stops before the slot whose
transmittance would fall below 1e-4.  The work is laid out differently from
every implementation of the port: the tiles are grouped by their slot count
and each group is evaluated as one (tiles, pixels, slots) block, the slots
innermost, with the transmittance chain as a cumulative product and the
prefix of the backward as a cumulative sum along them, both in f64, and no
footprint skip unless ``skip=True`` asks for one (which changes no
output).

``pair_counts`` gives, for one launch's inputs, the (slot, pixel) pairs that
pass the alpha cut before the pixel's stop: the work the inputs need,
whatever skips an implementation makes.
"""

from __future__ import annotations

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
TABLE_W = 12
OUT_ROWS = 5
BWD_ROWS = {"full": 12, "noabs": 10, "selonly": 2}
# elements of one (tiles, slots, pixels) block
BLOCK_ELEMENTS = 1 << 24
F64 = torch.float64


def tile_groups(tile_counts, npix: int, budget: int = BLOCK_ELEMENTS):
    """Tiles in groups of about ``budget`` (tile, slot, pixel) elements,
    tiles of similar counts together: a list of (tile indices, slots)."""
    counts = tile_counts.long()
    order = torch.argsort(counts, descending=True, stable=True)
    c = counts[order].tolist()
    groups, i = [], 0
    while i < len(c):
        s = max(c[i], 1)
        n = max(1, budget // (s * npix))
        groups.append((order[i:i + n], c[i]))
        i += n
    return groups


def gather_group(table, sorted_ids, tile_starts, tile_counts, tiles, S):
    """The slots of a group of tiles: slot (G, S), in_range (G, S) and the
    table rows (G, S, w)."""
    P = sorted_ids.shape[0]
    k = torch.arange(max(S, 1), device=table.device)[None, :]
    in_range = k < tile_counts.long()[tiles][:, None]
    slot = torch.clamp(tile_starts.long()[tiles][:, None] + k, max=max(P - 1, 0))
    rows = table[sorted_ids[slot].long()]
    return slot, in_range, rows


def chain(alpha, hit, dim: int = 1):
    """The transmittance chain over the slot axis ``dim`` in f64: the
    transmittance before each slot, 1 - alpha, and the pairs taken
    (hit, and before the pixel's stop)."""
    a = alpha.to(F64)
    one_m = 1.0 - a
    f = torch.where(hit, one_m, torch.ones_like(one_m))
    n = f.shape[dim]
    t_in = torch.cat([torch.ones_like(f.narrow(dim, 0, 1)),
                      torch.cumprod(f, dim=dim).narrow(dim, 0, n - 1)], dim=dim)
    U = t_in * one_m
    stop = hit & (U < T_EPS)
    stopped_before = (torch.cumsum(stop.to(torch.int32), dim=dim) - stop.to(torch.int32)) > 0
    take = hit & ~stop & ~stopped_before
    return a, t_in, one_m, take


def _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S, tiles_x,
              ts, skip: bool):
    """Alpha of every (pixel, slot) of a group of tiles, as the kernels
    compute it in f32: (G, npix, S) blocks; the per-slot values (G, 1, S)."""
    dev = table.device
    f32 = torch.float32
    npix = ts * ts
    slot, in_range, rows = gather_group(table, sorted_ids, tile_starts,
                                        tile_counts, tiles, S)
    p = torch.arange(npix, device=dev)
    px = (p % ts).to(f32)[:, None]
    py = torch.div(p, ts, rounding_mode="floor").to(f32)[:, None]
    ox = ((tiles % tiles_x) * ts).to(f32)[:, None]
    oy = (torch.div(tiles, tiles_x, rounding_mode="floor") * ts).to(f32)[:, None]
    gx = (rows[..., 0] - ox)[:, None]
    gy = (rows[..., 1] - oy)[:, None]
    a, b, c = (rows[..., i][:, None] for i in (2, 3, 4))
    opa = torch.where(in_range & (rows[..., 10] > 0), rows[..., 5],
                      torch.zeros_like(rows[..., 5]))[:, None]
    dx = px - gx
    dy = py - gy
    power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy, max=0.0)
    alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
    hit = (alpha >= ALPHA_MIN) & in_range[:, None]
    if skip:
        hit = hit & _reach(gx, gy, a, b, c, opa, px, py)
    return dict(slot=slot, in_range=in_range, rows=rows, dx=dx, dy=dy,
                alpha=alpha, hit=hit, a=a, b=b, c=c)


def _reach(gx, gy, a, b, c, opa, px, py):
    """A conservative footprint skip: a pixel farther from the centre than
    the largest axis of the 1/255 ellipse (with a margin) cannot pass the
    cut.  Keeps every pair of a non-positive-definite or non-finite conic."""
    det = a * c - b * b
    lmin = 0.5 * (a + c) - torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    tau = torch.log(torch.clamp(opa, min=1e-30) * 255.0)
    r2 = 2.0 * torch.clamp(tau, min=0.0) / torch.clamp(lmin, min=1e-30)
    d2 = (px - gx) ** 2 + (py - gy) ** 2
    ok = (det > 0) & (lmin > 0) & torch.isfinite(r2)
    return ~ok | (d2 <= r2 * 1.01 + 1.0)


def composite_fwd(table, sorted_ids, tile_starts, tile_counts, tiles_x: int,
                  tiles_y: int, tile_size: int, skip: bool = False) -> torch.Tensor:
    """(T, 5, ts²) rows [r, g, b, depth, alpha = 1 - T_final]."""
    num_tiles = tiles_x * tiles_y
    npix = tile_size * tile_size
    out = torch.zeros((num_tiles, OUT_ROWS, npix), dtype=torch.float32,
                      device=table.device)
    for tiles, S in tile_groups(tile_counts, npix):
        g = _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S,
                      tiles_x, tile_size, skip)
        a, t_in, one_m, take = chain(g["alpha"], g["hit"], -1)
        w = torch.where(take, a * t_in, torch.zeros_like(a))
        cols = g["rows"][..., 6:10].to(F64)                     # (G, S, 4)
        acc = torch.einsum("gps,gsc->gcp", w, cols)
        t_fin = torch.prod(torch.where(take, one_m, torch.ones_like(one_m)), dim=-1)
        out[tiles, 0:4] = acc.to(torch.float32)
        out[tiles, 4] = (1.0 - t_fin).to(torch.float32)
    return out


def composite_bwd(table, sorted_ids, tile_starts, tile_counts, gc4, g2,
                  tiles_x: int, tiles_y: int, tile_size: int,
                  mode: str = "full") -> torch.Tensor:
    """(P, BWD_ROWS[mode]) per-slot sums over the tile's pixels, in the
    columns of the port's ``composite_bwd``."""
    npix = tile_size * tile_size
    P = sorted_ids.shape[0]
    out = torch.zeros((P, BWD_ROWS[mode]), dtype=torch.float32, device=table.device)
    for tiles, S in tile_groups(tile_counts, npix, BLOCK_ELEMENTS // 2):
        g = _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S,
                      tiles_x, tile_size, False)
        a, t_in, one_m, take = chain(g["alpha"], g["hit"], -1)
        zero = torch.zeros((), dtype=F64, device=a.device)
        w = torch.where(take, a * t_in, zero)
        col = g["rows"].to(F64)[:, None]                        # (G, 1, S, 12)
        gc = gc4[tiles].to(F64)[..., None]                      # (G, 4, P, 1)
        gr, gg, gb, gd = gc[:, 0], gc[:, 1], gc[:, 2], gc[:, 3]
        contrib = gr * col[..., 6] + gg * col[..., 7] + gb * col[..., 8] + gd * col[..., 9]
        prefix = torch.cumsum(torch.where(take, contrib * w, zero), dim=-1)
        suffix = g2[tiles].to(F64)[..., None] - prefix
        g_alpha = contrib * t_in - suffix / torch.clamp(one_m, min=1.0 - ALPHA_MAX)
        g_power = torch.where(take & (a < ALPHA_MAX), g_alpha * a, zero)
        dx, dy = g["dx"].to(F64), g["dy"].to(F64)
        ca, cb, cc = g["a"].to(F64), g["b"].to(F64), g["c"].to(F64)
        gx = g_power * (ca * dx + cb * dy)
        gy = g_power * (cc * dy + cb * dx)
        if mode == "selonly":
            cols = [gx.abs(), gy.abs()]
        else:
            gh = g_power * -0.5
            cols = [gx, gy, gh * dx * dx, g_power * (-dx * dy), gh * dy * dy,
                    g_power, w * gr, w * gg, w * gb, w * gd]
            if mode == "full":
                cols += [gx.abs(), gy.abs()]
        vals = torch.stack([v.sum(1) for v in cols], dim=-1)    # (G, S, W)
        if mode != "selonly":
            vals[..., 5] = vals[..., 5] / torch.clamp(col[:, 0, :, 5], min=1e-12)
        ok = g["in_range"]
        out[g["slot"][ok]] = vals[ok].to(torch.float32)
    return out


def pair_counts(table, sorted_ids, tile_starts, tile_counts, tiles_x: int,
                tiles_y: int, tile_size: int, skip: bool = False) -> int:
    """(slot, pixel) pairs of one launch that pass the alpha cut before the
    pixel's stop."""
    n = 0
    for tiles, S in tile_groups(tile_counts, tile_size * tile_size):
        g = _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S,
                      tiles_x, tile_size, skip)
        n += int(chain(g["alpha"], g["hit"], -1)[3].sum())
    return n

"""The plain reference compositors of the benchmark: 2DGS surfel forward
and backward as batched tensor operations.

The inputs and outputs of the port's ``splat/surfel_kernels.py`` (its
docstring gives the layouts), with the same semantics: the affine cross
product cr = a + X·b + Y·c, the |cr_z| < 1e-8 guard, the circular cut
d² <= rad², the object-space power against the screen filter's, alpha in f32
in the kernels' order of operations, the 1/255 and near-plane cuts, and a
pixel that stops before the slot whose transmittance would fall below 1e-4.
The tiles are grouped by slot count and each group is one (tiles, slots,
pixels) block, with the chain as a cumulative product and the sums in f64,
as in ``kernels.py``.
"""

from __future__ import annotations

import torch

from .kernels import BLOCK_ELEMENTS, F64, chain, gather_group, tile_groups

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
NEAR_CULL = 0.2
FILTER_2D_VAR = 2.0
ONE_M_FLOOR = 0.01
TABLE_W = 24
(AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, DET, PX, PY, OPA, R, G, BL, NX, NY, NZ,
 RAD) = range(20)
FWD_ROWS = ("r", "g", "b", "nx", "ny", "nz", "dexp", "dmed", "dist", "wsum",
            "m1", "m2", "t_fin")
SURFEL_BWD_ROWS = {"full": 19, "selonly": 2}


def _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S, tiles_x,
              ts):
    """Per-(slot, pixel) quantities of a group of tiles, in f32 as the
    kernels compute them."""
    dev = table.device
    f32 = torch.float32
    slot, in_range, rows = gather_group(table, sorted_ids, tile_starts,
                                        tile_counts, tiles, S)
    p = torch.arange(ts * ts, device=dev)
    X = (((tiles % tiles_x) * ts)[:, None] + (p % ts)[None, :]).to(f32)[:, None]
    Y = ((torch.div(tiles, tiles_x, rounding_mode="floor") * ts)[:, None]
         + torch.div(p, ts, rounding_mode="floor")[None, :]).to(f32)[:, None]
    col = lambda i: rows[..., i][..., None]                     # (G, S, 1)
    dx = X - col(PX)
    dy = Y - col(PY)
    d2 = dx * dx + dy * dy
    inside = (d2 <= col(RAD) * col(RAD)) & in_range[..., None]
    crx = (col(AX) + X * col(BX)) + Y * col(CX)
    cry = (col(AY) + X * col(BY)) + Y * col(CY)
    crz = (col(AZ) + X * col(BZ)) + Y * col(CZ)
    safe = torch.where(crz.abs() < 1e-8, torch.full_like(crz, 1e-8), crz)
    rz = 1.0 / safe
    u = crx * rz
    v = cry * rz
    g3d = -0.5 * (u * u + v * v)
    g2d = -0.25 * d2
    power = torch.maximum(g3d, g2d)
    zhit = col(DET) * rz
    alpha = torch.clamp(col(OPA) * torch.exp(power), max=ALPHA_MAX)
    ok = inside & (alpha >= ALPHA_MIN) & (zhit > NEAR_CULL)
    return dict(slot=slot, in_range=in_range, rows=rows, ok=ok, alpha=alpha,
                zhit=zhit, crx=crx, cry=cry, crz=crz, rz=rz, sel3=g3d >= g2d,
                dx=dx, dy=dy, X=X, Y=Y)


def _mapped_depth(zhit, planes):
    znear, zfar = planes[0].to(F64), planes[1].to(F64)
    F = zfar / (zfar - znear)
    return F * (1.0 - znear / torch.clamp(zhit.to(F64), min=1e-6)), F, znear


def surfel_fwd(table, sorted_ids, tile_starts, tile_counts, planes,
               tiles_x: int, tiles_y: int, tile_size: int) -> torch.Tensor:
    """(T, 13, ts²) rows ``FWD_ROWS``."""
    num_tiles = tiles_x * tiles_y
    npix = tile_size * tile_size
    out = torch.zeros((num_tiles, len(FWD_ROWS), npix), dtype=torch.float32,
                      device=table.device)
    out[:, 12] = 1.0
    for tiles, S in tile_groups(tile_counts, npix, BLOCK_ELEMENTS // 2):
        g = _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S,
                      tiles_x, tile_size)
        a, t_in, one_m, take = chain(g["alpha"], g["ok"])
        zero = torch.zeros((), dtype=F64, device=a.device)
        w = torch.where(take, a * t_in, zero)
        z = g["zhit"].to(F64)
        m, _, _ = _mapped_depth(g["zhit"], planes)
        cols = g["rows"][..., R:NZ + 1].to(F64)                 # (G, S, 6)
        acc = torch.einsum("gsp,gsc->gcp", w, cols)
        U = t_in * one_m
        cross = take & (t_in > 0.5) & (U < 0.5)
        dmed = torch.where(cross, z, zero).sum(1)
        wm = w * m
        wsum, m1, m2 = w.sum(1), wm.sum(1), (wm * m).sum(1)
        t_fin = torch.prod(torch.where(take, one_m, torch.ones_like(one_m)), dim=1)
        rows = torch.cat([acc, torch.stack(
            [(w * z).sum(1), dmed, wsum * m2 - m1 * m1, wsum, m1, m2, t_fin], 1)], 1)
        out[tiles] = rows.to(torch.float32)
    return out


def surfel_bwd(table, sorted_ids, tile_starts, tile_counts, planes, cot8, aux5,
               tiles_x: int, tiles_y: int, tile_size: int,
               mode: str = "full") -> torch.Tensor:
    """(P, SURFEL_BWD_ROWS[mode]) per-slot sums over the tile's pixels, in
    the columns of the port's ``surfel_bwd``."""
    npix = tile_size * tile_size
    full = mode == "full"
    P = sorted_ids.shape[0]
    out = torch.zeros((P, SURFEL_BWD_ROWS[mode]), dtype=torch.float32,
                      device=table.device)
    for tiles, S in tile_groups(tile_counts, npix, BLOCK_ELEMENTS // 4):
        g = _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S,
                      tiles_x, tile_size)
        a, t_in, one_m, take = chain(g["alpha"], g["ok"])
        zero = torch.zeros((), dtype=F64, device=a.device)
        w = torch.where(take, a * t_in, zero)
        r = g["rows"].to(F64)[..., None]                        # (G, S, 24, 1)
        c8 = cot8[tiles].to(F64)[:, None]                       # (G, 1, 8, P)
        G2, gdmed, wtot, m1tot, m2tot = aux5[tiles].to(F64)[:, None].unbind(2)
        z = g["zhit"].to(F64)
        cw = (c8[:, :, 0] * r[:, :, R] + c8[:, :, 1] * r[:, :, G]) + c8[:, :, 2] * r[:, :, BL]
        if full:
            m, F, znear = _mapped_depth(g["zhit"], planes)
            cw = ((((cw + c8[:, :, 3] * r[:, :, NX]) + c8[:, :, 4] * r[:, :, NY])
                   + c8[:, :, 5] * r[:, :, NZ]) + c8[:, :, 6] * z)
            cw = cw + c8[:, :, 7] * ((m2tot + (m * m) * wtot) - (2.0 * m) * m1tot)
        prefix = torch.cumsum(torch.where(take, cw * w, zero), dim=1)
        g_alpha = cw * t_in - (G2 - prefix) / torch.clamp(one_m, min=ONE_M_FLOOR)
        g_power = torch.where(take & (a < ALPHA_MAX), g_alpha * a, zero)
        sel3 = g["sel3"]
        g3 = torch.where(sel3, g_power, zero)
        g2 = torch.where(sel3, zero, g_power)
        crx, cry, rz = g["crx"].to(F64), g["cry"].to(F64), g["rz"].to(F64)
        rz2 = rz * rz
        d_crx = -crx * rz2 * g3
        d_cry = -cry * rz2 * g3
        d_crz = (crx * crx + cry * cry) * rz2 * rz * g3
        gx2 = g2 * g["dx"].to(F64) * 0.5
        gy2 = g2 * g["dy"].to(F64) * 0.5
        if full:
            gm = 2.0 * c8[:, :, 7] * w * (m * wtot - m1tot)
            dmdz = (F * znear) / (z * z)
            crossed = take & (t_in > 0.5) & (t_in * one_m < 0.5)
            gz = (w * c8[:, :, 6] + gm * dmdz) + torch.where(crossed, gdmed, zero)
            d_crz = d_crz - gz * r[:, :, DET] * rz2
        d_crz = torch.where(g["crz"].abs() < 1e-8, zero, d_crz)
        if full:
            X, Y = g["X"].to(F64), g["Y"].to(F64)
            cols = [d_crx, d_cry, d_crz, d_crx * X, d_cry * X, d_crz * X,
                    d_crx * Y, d_cry * Y, d_crz * Y, gz * rz, gx2, gy2,
                    g_power, w * c8[:, :, 0], w * c8[:, :, 1], w * c8[:, :, 2],
                    w * c8[:, :, 3], w * c8[:, :, 4], w * c8[:, :, 5]]
        else:
            gx = -((d_crx * r[:, :, BX] + d_cry * r[:, :, BY]) + d_crz * r[:, :, BZ]) + gx2
            gy = -((d_crx * r[:, :, CX] + d_cry * r[:, :, CY]) + d_crz * r[:, :, CZ]) + gy2
            cols = [gx.abs(), gy.abs()]
        vals = torch.stack([torch.where(take, v, zero).sum(-1) for v in cols], -1)
        if full:
            vals[..., OPA] = vals[..., OPA] / torch.clamp(r[:, :, OPA, 0], min=1e-12)
        ok = g["in_range"]
        out[g["slot"][ok]] = vals[ok].to(torch.float32)
    return out


def pair_counts(table, sorted_ids, tile_starts, tile_counts, planes,
                tiles_x: int, tiles_y: int, tile_size: int) -> int:
    """(slot, pixel) pairs of one launch that pass the cuts before the
    pixel's stop."""
    n = 0
    for tiles, S in tile_groups(tile_counts, tile_size * tile_size,
                                BLOCK_ELEMENTS // 2):
        g = _geometry(table, sorted_ids, tile_starts, tile_counts, tiles, S,
                      tiles_x, tile_size)
        n += int(chain(g["alpha"], g["ok"])[3].sum())
    return n

"""The 2DGS surfel compositing kernels: CUDA kernel wrappers and the plain
PyTorch versions.

Replaces ``generativedensification_tpu/splat/pallas_surfel.py``'s
``pallas_surfel_fwd`` (``csrc/surfel_fwd.cu``) and ``pallas_surfel_bwd``
(``csrc/surfel_bwd.cu``).  Both sources are registered in
``kernels._libraries``: ``kernels.launch`` builds them with the 3DGS
kernels at first use and counts their launches in ``kernels.launch_counts``.

``surfel_fwd`` and ``surfel_bwd`` are the entries: tensors on the card launch
the kernel (or raise), tensors on the CPU take the plain version.

Semantics: those of the JAX ``_xla_scan_fwd`` (global pixel coordinates,
cr = a + X·b + Y·c, the |cr_z| < 1e-8 guard, the circular cut d² <= rad²)
with one serial transmittance chain shared by the kernels and the plain
versions: a pixel stops for good before the slot whose U = T(1 - alpha)
falls below 1e-4, as the Pallas kernels and the 3DGS compositor do.  The
distortion is kept in the closed form of ``pallas_surfel.py``:
dist = ΣW·M2 − M1², with ∂dist/∂w_i = M2 + m_i²·ΣW − 2·m_i·M1.

Inputs shared by both kernels:
  table       (N, 24) f32 per-surfel rows [acr (3), bcr (3), ccr (3), det,
              px, py, opacity, r, g, b, nx, ny, nz, rad, 0 (4)]
  sorted_ids  (P,) i32 surfel of each depth-sorted slot
  tile_starts (T,) i32 first slot of each tile's segment
  tile_counts (T,) i32 slots per tile, already clamped to the per-tile cap
  planes      (2,) f32 [znear, zfar] of the camera (the distortion's mapped
              depth), on the card with the rest: no host round trip
Forward output: (T, 13, ts²) f32 rows ``FWD_ROWS``.  Backward inputs: cot8
(T, 8, ts²) rows [gC (3), gN (3), gDexp, gdist] and aux5 (T, 5, ts²) rows
[G2, gDmed, ΣW, M1, M2] (``surfel.composite_surfels_backward`` builds both).
Backward output: (P, SURFEL_BWD_ROWS[mode]) f32, one row per slot.

The CUDA kernels composite each tile as 16 x 16 sub-tiles and skip the slots
whose screen circle cannot reach a sub-tile's pixel centres; ``subtile_touch``
is that predicate in PyTorch, and the plain versions take its result as
``touch=`` (dropped pairs culled, which changes no bit).
"""

from __future__ import annotations

import torch

from . import kernels
from .kernels import CHUNK, SUBTILE, T_EPS, _segment_slots, _subtile_of_pixel, _touch_mask

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
NEAR_CULL = 0.2
FILTER_2D_VAR = 2.0     # the screen-space low-pass variance, px²
# 1 - ALPHA_MAX as the JAX package rounds it (the f32 nearest 0.01)
ONE_M_FLOOR = 0.01
TABLE_W = 24
(AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, DET, PX, PY, OPA, R, G, BL, NX, NY, NZ,
 RAD) = range(20)
# forward output rows: color and normal accumulators, expected depth, median
# depth (the T = 0.5 crossing), distortion, the moments ΣW, M1 = Σw·m,
# M2 = Σw·m², and the final transmittance
FWD_ROWS = ("r", "g", "b", "nx", "ny", "nz", "dexp", "dmed", "dist", "wsum",
            "m1", "m2", "t_fin")
# per-slot rows of each backward mode: ``full`` the 19 attribute gradients
# in table order (acr, bcr, ccr, det, px, py, opacity, color, normal);
# ``selonly`` the AbsGS |d/dscreen x|, |d/dscreen y| sums
SURFEL_BWD_ROWS = {"full": 19, "selonly": 2}
_BWD_MODE_ID = {"full": 0, "selonly": 1}
# the margins of the CUDA kernels' screen-circle skip
# (csrc/surfel_subtile.cuh): a slot is dropped for a sub-tile only where the
# squared distance from its centre to the sub-tile's pixel centres exceeds
# rad² (1 + SKIP_MARGIN_REL) + SKIP_MARGIN_ABS
SKIP_MARGIN_REL = 2.0 ** -16
SKIP_MARGIN_ABS = 2.0 ** -100


def _check_inputs(table, sorted_ids, tile_starts, tile_counts, planes,
                  num_tiles):
    if planes.dtype != torch.float32 or tuple(planes.shape) != (2,):
        raise ValueError(f"planes must be (2,) float32 [znear, zfar], got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    kernels._check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles,
                          TABLE_W)


def surfel_fwd(table, sorted_ids, tile_starts, tile_counts, planes,
               tiles_x: int, tiles_y: int, tile_size: int) -> torch.Tensor:
    """Composite every tile; (T, 13, ts²) rows ``FWD_ROWS``."""
    num_tiles = tiles_x * tiles_y
    _check_inputs(table, sorted_ids, tile_starts, tile_counts, planes, num_tiles)
    if table.device.type == "cpu":
        return surfel_fwd_plain(table, sorted_ids, tile_starts, tile_counts,
                                planes, tiles_x, tiles_y, tile_size)
    dev = kernels._check_cuda("surfel_fwd", tile_size, table, sorted_ids, tile_starts,
                              tile_counts, planes)
    out = torch.empty((num_tiles, len(FWD_ROWS), tile_size * tile_size),
                      dtype=torch.float32, device=dev)
    kernels.launch("surfel_fwd", dev, table.data_ptr(), sorted_ids.data_ptr(),
                   tile_starts.data_ptr(), tile_counts.data_ptr(), planes.data_ptr(),
                   out.data_ptr(), num_tiles, tiles_x, tile_size)
    return out


def _pixel_coords(tiles_x, tiles_y, ts, dev):
    """Global pixel coordinates (T, ts²) of every tile's pixels."""
    f32 = torch.float32
    p = torch.arange(ts * ts, device=dev)
    t = torch.arange(tiles_x * tiles_y, device=dev)
    X = ((t % tiles_x) * ts)[:, None] + (p % ts)[None, :]
    Y = (torch.div(t, tiles_x, rounding_mode="floor") * ts)[:, None] + \
        torch.div(p, ts, rounding_mode="floor")[None, :]
    return X.to(f32), Y.to(f32)


def _chunk_geometry(table, sorted_ids, starts, counts, c0, X, Y, touch=None,
                    q_of_pixel=None):
    """One chunk of CHUNK slots of every tile, gathered and evaluated as a
    (T, CHUNK, ts²) block in the kernels' order and rounding.  Returns the
    slot rows, the in-range mask and the per-(slot, pixel) quantities;
    with ``touch`` (``subtile_touch``'s mask and ``q_of_pixel``, each
    pixel's sub-tile) the pairs the skip drops fail the circle test, and
    ``kept`` marks the pairs the skip leaves."""
    P = sorted_ids.shape[0]
    k = torch.arange(CHUNK, device=table.device)[None, :]
    in_range = (c0 + k) < counts                                # (T, K)
    slot = torch.clamp(starts + c0 + k, max=max(P - 1, 0))
    rows = table[sorted_ids[slot].long()]                       # (T, K, 24)
    col = lambda i: rows[..., i][..., None]                    # (T, K, 1)
    Xb, Yb = X[:, None, :], Y[:, None, :]
    dx = Xb - col(PX)
    dy = Yb - col(PY)
    d2 = dx * dx + dy * dy
    inside = (d2 <= col(RAD) * col(RAD)) & in_range[..., None]
    kept = None if touch is None else _touch_mask(touch, slot, q_of_pixel)
    if kept is not None:
        inside = inside & kept
    crx = (col(AX) + Xb * col(BX)) + Yb * col(CX)
    cry = (col(AY) + Xb * col(BY)) + Yb * col(CY)
    crz = (col(AZ) + Xb * col(BZ)) + Yb * col(CZ)
    safe = torch.where(crz.abs() < 1e-8, torch.full_like(crz, 1e-8), crz)
    rz = 1.0 / safe
    u = crx * rz
    v = cry * rz
    g3d = -0.5 * (u * u + v * v)
    g2d = -0.25 * d2            # -0.5 d² / FILTER_2D_VAR, exact
    power = torch.maximum(g3d, g2d)
    zhit = col(DET) * rz
    alpha = torch.clamp(col(OPA) * torch.exp(power), max=ALPHA_MAX)
    ok = inside & (alpha >= ALPHA_MIN) & (zhit > NEAR_CULL)
    return dict(rows=rows, slot=slot, in_range=in_range, inside=inside, ok=ok,
                kept=kept, alpha=alpha, zhit=zhit, crx=crx, cry=cry, crz=crz, rz=rz,
                sel3=g3d >= g2d, dx=dx, dy=dy)


def subtile_keep(px, py, rad, x0, y0) -> torch.Tensor:
    """The screen-circle skip's predicate, elementwise (f32 tensors that
    broadcast): can the circle of centre (px, py) and radius ``rad`` reach
    a pixel centre of the 16 x 16 rectangle [x0, x0 + 15] x [y0, y0 + 15]
    (global pixel coordinates) under the kernels' rounded test
    d² <= rad·rad?  The PyTorch mirror of
    ``csrc/surfel_subtile.cuh::circle_keep``, operation for operation in
    f32: e² = ex² + ey², with ex the distance from px to the rectangle's
    column range (0 inside it) and ey likewise, against
    rad² (1 + SKIP_MARGIN_REL) + SKIP_MARGIN_ABS.  Keeps every slot with a
    non-finite centre or radius."""
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=px.device)
    x0 = torch.as_tensor(x0, dtype=f32, device=px.device)
    y0 = torch.as_tensor(y0, dtype=f32, device=px.device)
    x1, y1 = x0 + (SUBTILE - 1), y0 + (SUBTILE - 1)
    ex = torch.where(px < x0, x0 - px, torch.where(px > x1, px - x1, zero))
    ey = torch.where(py < y0, y0 - py, torch.where(py > y1, py - y1, zero))
    e2 = ex * ex + ey * ey
    rad2 = rad * rad
    keep = ~(e2 > rad2 + (SKIP_MARGIN_REL * rad2 + SKIP_MARGIN_ABS))
    finite = torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(rad)
    return torch.where(finite, keep, True)


def subtile_touch(table, sorted_ids, tile_starts, tile_counts, tiles_x: int,
                  tiles_y: int, tile_size: int) -> torch.Tensor:
    """The screen-circle skip of the CUDA surfel kernels for every
    (sub-tile, slot): a (ts² / 256, P) bool tensor, row q = qy * (ts / 16) +
    qx the tile's 16 x 16 sub-tile, True where the kernels keep the slot for
    that sub-tile of its tile (``subtile_keep``), False for slots in no
    tile's segment.  Measurement and tests only: the kernels decide on the
    card."""
    num_tiles = tiles_x * tiles_y
    kernels._check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles,
                          TABLE_W)
    dev = table.device
    side = tile_size // SUBTILE
    if side * SUBTILE != tile_size:
        raise ValueError(f"tile size {tile_size} is not a multiple of {SUBTILE}")
    tile, slot = _segment_slots(tile_starts, tile_counts)
    rows = table[sorted_ids[slot].long()]
    ox = (tile % tiles_x) * tile_size
    oy = torch.div(tile, tiles_x, rounding_mode="floor") * tile_size
    touch = torch.zeros((side * side, sorted_ids.shape[0]), dtype=torch.bool,
                        device=dev)
    for q in range(side * side):
        x0 = (ox + (q % side) * SUBTILE).to(torch.float32)
        y0 = (oy + (q // side) * SUBTILE).to(torch.float32)
        touch[q, slot] = subtile_keep(rows[:, PX], rows[:, PY], rows[:, RAD], x0, y0)
    return touch


def _count_evals(n, alive, g, j):
    """Add slot j's (slot, live pixel) evaluations of a chunk to the
    counts ``n``: all of them, those the skip leaves and those inside the
    circle."""
    live = alive & g["in_range"][:, j:j + 1]
    n["evals"] += live.sum()
    n["evals_kept"] += (live if g["kept"] is None else live & g["kept"][:, j]).sum()
    n["inside"] += (live & g["inside"][:, j]).sum()


def _report(stats, n, touch):
    if stats is not None:
        stats.update({k: int(v) for k, v in n.items()
                      if k != "evals_kept" or touch is not None})


def _mapped_depth(zhit, planes):
    """m = zfar / (zfar - znear) · (1 - znear / max(z, 1e-6)), and F (the
    first factor) and znear."""
    znear, zfar = planes[0], planes[1]
    F = zfar / (zfar - znear)
    return F * (1.0 - znear / torch.clamp(zhit, min=1e-6)), F, znear


def surfel_fwd_plain(table, sorted_ids, tile_starts, tile_counts, planes,
                     tiles_x: int, tiles_y: int, tile_size: int,
                     stats: dict | None = None,
                     touch: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: chunks of CHUNK slots of
    every tile are gathered and their alpha computed as one (T, CHUNK, ts²)
    block; the transmittance chain then steps through the chunk slot by
    slot, in the kernel's order and rounding, so this version is the
    kernel's bit-level reference.

    ``touch``, if given (``subtile_touch``'s (sub-tiles, P) mask), culls the
    (slot, sub-tile) pairs it drops, as the kernel's screen-circle skip
    does; the output is the same.  ``stats``, if given, receives the
    (slot, live pixel) evaluations, those the skip leaves (``evals_kept``,
    with ``touch``), those inside the slot's circle, and the contributing
    pairs (the kernel's data-dependent work, for its roofline bound)."""
    dev = table.device
    f32 = torch.float32
    num_tiles = tiles_x * tiles_y
    npix = tile_size * tile_size
    X, Y = _pixel_coords(tiles_x, tiles_y, tile_size, dev)
    zero = lambda: torch.zeros((num_tiles, npix), dtype=f32, device=dev)
    T = torch.ones((num_tiles, npix), dtype=f32, device=dev)
    acc = torch.zeros((6, num_tiles, npix), dtype=f32, device=dev)  # color, normal
    dexp, dmed, wsum, m1, m2 = zero(), zero(), zero(), zero(), zero()
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("evals", "evals_kept", "inside", "contribs")}
    q_of_pixel = None if touch is None else _subtile_of_pixel(tile_size, dev)

    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        g = _chunk_geometry(table, sorted_ids, starts, counts, c0, X, Y, touch,
                            q_of_pixel)
        m, _, _ = _mapped_depth(g["zhit"], planes)
        cols = g["rows"][..., R:NZ + 1].permute(1, 2, 0)        # (K, 6, T)
        for j in range(min(CHUNK, max_count - c0)):
            a_j, z_j, m_j = g["alpha"][:, j], g["zhit"][:, j], m[:, j]
            if stats is not None:
                _count_evals(n, alive, g, j)
            use = alive & g["ok"][:, j]
            U = T * (1.0 - a_j)
            stop = use & (U < T_EPS)
            alive = alive & ~stop
            take = use & ~stop
            dmed = torch.where(take & (T > 0.5) & (U < 0.5), z_j, dmed)
            w = a_j * T
            acc = torch.where(take, acc + w * cols[j][..., None], acc)
            dexp = torch.where(take, dexp + w * z_j, dexp)
            wm = w * m_j
            wsum = torch.where(take, wsum + w, wsum)
            m1 = torch.where(take, m1 + wm, m1)
            m2 = torch.where(take, m2 + wm * m_j, m2)
            T = torch.where(take, U, T)
            if stats is not None:
                n["contribs"] += take.sum()
    _report(stats, n, touch)
    dist = wsum * m2 - m1 * m1
    return torch.stack([*acc, dexp, dmed, dist, wsum, m1, m2, T], dim=1)


def _check_bwd(cot8, aux5, num_tiles, tile_size, mode):
    npix = tile_size * tile_size
    if mode not in SURFEL_BWD_ROWS:
        raise ValueError(f"mode must be one of {tuple(SURFEL_BWD_ROWS)}, "
                         f"got {mode!r}")
    for name, t, rows in (("cot8", cot8, 8), ("aux5", aux5, 5)):
        if t.dtype != torch.float32 or tuple(t.shape) != (num_tiles, rows, npix):
            raise ValueError(f"{name} must be ({num_tiles}, {rows}, {npix}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")


def surfel_bwd(table, sorted_ids, tile_starts, tile_counts, planes, cot8, aux5,
               tiles_x: int, tiles_y: int, tile_size: int,
               mode: str = "full") -> torch.Tensor:
    """Per-slot surfel compositing gradients, (P, SURFEL_BWD_ROWS[mode]):
    row s holds the sums over its tile's pixels for sorted slot s.  Slots
    that no tile composites (dead, past the per-tile cap, or past the
    tile's early exit) are zero.  The per-surfel sum over a surfel's slots
    is the caller's (``composite.slots_to_gaussians``)."""
    num_tiles = tiles_x * tiles_y
    _check_inputs(table, sorted_ids, tile_starts, tile_counts, planes, num_tiles)
    _check_bwd(cot8, aux5, num_tiles, tile_size, mode)
    if table.device.type == "cpu":
        return surfel_bwd_plain(table, sorted_ids, tile_starts, tile_counts,
                                planes, cot8, aux5, tiles_x, tiles_y, tile_size,
                                mode)
    dev = kernels._check_cuda("surfel_bwd", tile_size, table, sorted_ids, tile_starts,
                              tile_counts, planes, cot8, aux5)
    out = torch.zeros((sorted_ids.shape[0], SURFEL_BWD_ROWS[mode]),
                      dtype=torch.float32, device=dev)
    kernels.launch("surfel_bwd", dev, table.data_ptr(), sorted_ids.data_ptr(),
                   tile_starts.data_ptr(), tile_counts.data_ptr(), planes.data_ptr(),
                   cot8.data_ptr(), aux5.data_ptr(), out.data_ptr(), num_tiles, tiles_x,
                   tile_size, _BWD_MODE_ID[mode])
    return out


def surfel_bwd_plain(table, sorted_ids, tile_starts, tile_counts, planes, cot8,
                     aux5, tiles_x: int, tiles_y: int, tile_size: int,
                     mode: str = "full", stats: dict | None = None,
                     touch: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel.  The chain (alpha, T,
    the include test and the prefix of cw · w) steps slot by slot in the
    kernel's order and rounding, as the forward's plain version does; each
    slot's rows are summed over the tile's pixels (in another order than the
    kernel's shuffle tree, so the two agree to rounding, not bitwise).

    Per included (slot, pixel), with T the transmittance before the slot:
      cw      = gC·color + gN·normal + gDexp·z + gdist·(M2 + m²·ΣW − 2m·M1)
      g_alpha = cw·T − (G2 − prefix) / max(1 − alpha, 0.01)
      g_power = g_alpha·alpha (0 where alpha is clamped at 0.99)
    then the object-space branch through cr = a + X·b + Y·c and z = det/cr_z
    (``full``: with gz = w·gDexp + dL/dm·dm/dz + gDmed at the median
    crossing) or the screen-space filter branch, whichever set the power.

    ``touch`` and ``stats`` as in ``surfel_fwd_plain``."""
    dev = table.device
    f32 = torch.float32
    num_tiles = tiles_x * tiles_y
    npix = tile_size * tile_size
    full = mode == "full"
    X, Y = _pixel_coords(tiles_x, tiles_y, tile_size, dev)
    P = sorted_ids.shape[0]
    out = torch.zeros((P, SURFEL_BWD_ROWS[mode]), dtype=f32, device=dev)
    T = torch.ones((num_tiles, npix), dtype=f32, device=dev)
    prefix = torch.zeros((num_tiles, npix), dtype=f32, device=dev)
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    gC, gN = cot8[:, 0:3], cot8[:, 3:6]
    gdexp, gdist = cot8[:, 6], cot8[:, 7]
    G2, gdmed, wtot, m1tot, m2tot = aux5.unbind(1)
    zero = torch.zeros((), dtype=f32, device=dev)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("evals", "evals_kept", "inside", "contribs")}
    q_of_pixel = None if touch is None else _subtile_of_pixel(tile_size, dev)

    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        g = _chunk_geometry(table, sorted_ids, starts, counts, c0, X, Y, touch,
                            q_of_pixel)
        m, F, znear = _mapped_depth(g["zhit"], planes)
        rows = g["rows"]
        for j in range(min(CHUNK, max_count - c0)):
            a_j, z_j = g["alpha"][:, j], g["zhit"][:, j]
            if stats is not None:
                _count_evals(n, alive, g, j)
            use = alive & g["ok"][:, j]
            one_m = 1.0 - a_j
            U = T * one_m
            stop = use & (U < T_EPS)
            alive = alive & ~stop
            take = use & ~stop
            w = torch.where(take, a_j * T, zero)
            r = rows[:, j, :, None]                             # (T, 24, 1)
            cw = (gC[:, 0] * r[:, R] + gC[:, 1] * r[:, G]) + gC[:, 2] * r[:, BL]
            if full:
                m_j = m[:, j]
                cw = ((((cw + gN[:, 0] * r[:, NX]) + gN[:, 1] * r[:, NY])
                       + gN[:, 2] * r[:, NZ]) + gdexp * z_j)
                ddist = (m2tot + (m_j * m_j) * wtot) - (2.0 * m_j) * m1tot
                cw = cw + gdist * ddist
            prefix = torch.where(take, prefix + cw * w, prefix)
            inv_1ma = 1.0 / torch.clamp(one_m, min=ONE_M_FLOOR)
            g_alpha = cw * T - (G2 - prefix) * inv_1ma
            g_power = torch.where(take & (a_j < ALPHA_MAX), g_alpha * a_j, zero)
            sel3 = g["sel3"][:, j]
            g3 = torch.where(sel3, g_power, zero)
            g2 = torch.where(sel3, zero, g_power)
            crx, cry = g["crx"][:, j], g["cry"][:, j]
            rz = g["rz"][:, j]
            rz2 = rz * rz
            d_crx = -crx * rz2 * g3
            d_cry = -cry * rz2 * g3
            d_crz = (crx * crx + cry * cry) * rz2 * rz * g3
            gx2 = g2 * g["dx"][:, j] * 0.5
            gy2 = g2 * g["dy"][:, j] * 0.5
            if full:
                gm = 2.0 * gdist * w * (m_j * wtot - m1tot)
                dmdz = (F * znear) / (z_j * z_j)
                crossed = take & (T > 0.5) & (U < 0.5)
                gz = (w * gdexp + gm * dmdz) + torch.where(crossed, gdmed, zero)
                d_crz = d_crz - gz * r[:, DET] * rz2
            d_crz = torch.where(g["crz"][:, j].abs() < 1e-8, zero, d_crz)
            if full:
                cols = [d_crx, d_cry, d_crz, d_crx * X, d_cry * X, d_crz * X,
                        d_crx * Y, d_cry * Y, d_crz * Y, gz * rz, gx2, gy2,
                        g_power, w * gC[:, 0], w * gC[:, 1], w * gC[:, 2],
                        w * gN[:, 0], w * gN[:, 1], w * gN[:, 2]]
            else:
                gx = -((d_crx * r[:, BX] + d_cry * r[:, BY]) + d_crz * r[:, BZ]) + gx2
                gy = -((d_crx * r[:, CX] + d_cry * r[:, CY]) + d_crz * r[:, CZ]) + gy2
                cols = [gx.abs(), gy.abs()]
            # the kernel adds nothing for a pixel that does not take the
            # slot (and so never meets an overflowed product times zero)
            vals = torch.stack([torch.where(take, v, zero).sum(-1) for v in cols],
                               dim=-1)                           # (T, W)
            if full:
                vals[:, OPA] = vals[:, OPA] / torch.clamp(r[:, OPA, 0], min=1e-12)
            ok = g["in_range"][:, j]
            out[g["slot"][ok, j]] = vals[ok]
            T = torch.where(take, U, T)
            if stats is not None:
                n["contribs"] += take.sum()
    _report(stats, n, touch)
    return out

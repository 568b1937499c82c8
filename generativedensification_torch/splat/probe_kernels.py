"""The stage probes of the two forward compositors: CUDA kernel wrappers,
launch counts, the plain PyTorch versions and the work each variant does.

Replace the TPU probe kernels of the JAX package's
``scripts/dev_kernel_break.py`` (``make_fwd``, ``make_fwd_hbm``,
``make_fwd_tpb``: ``csrc/composite_fwd_probe.cu``) and
``scripts/dev_surfel_break.py`` (``make_fwd``: ``csrc/surfel_fwd_probe.cu``).
Each variant is an instantiation of the production sub-tile body of the
forward it probes (``csrc/composite_subtile.cuh`` for kernel #1,
``csrc/surfel_subtile.cuh`` for kernel #3: one CTA of 256 threads per
16 x 16 sub-tile, the order-preserving skip, the CTA exit) with stages
switched off or another launch shape, so that a ladder times the code that
serves and trains; ``full`` is the production kernel.  The stages, each
adding to the one before:

- 3DGS (``COMPOSITE_VARIANTS``): ``noop`` (the launch shape, no input read),
  ``load`` (every slot staged, no predicate, no compaction), ``skip``
  (``subtile_keep`` and the ballot compaction), ``power``, ``alpha``
  (``power_floor``, ``expf``, the clamp and the 1/255 cull), ``trans`` (the
  transmittance chain, the stops and the CTA exit), ``full``; beside them
  ``noexit`` / ``noskip`` (production without its exit / its skip),
  ``b128`` (128 slots staged per batch), ``trips`` (the executed and
  assigned staging batches and the kept slots per CTA), ``noop_bulk`` /
  ``full_bulk`` (each CTA's output stored by bulk asynchronous copies) and
  ``tpb2`` / ``tpb4`` / ``tpb2_bulk`` / ``tpb4_bulk`` (2 or 4 consecutive
  sub-tiles per CTA; at 32 px ``tpb4`` is one whole tile per CTA).
- 2DGS (``SURFEL_VARIANTS``): ``noop``, ``load``, ``skip`` (``circle_keep``
  and the compaction), ``alpha`` (the front through alpha, no z),
  ``geomd`` (z, the z > 0.2 cull and the mapped depth), ``trans``, ``acc``
  (color, normal and sum w), ``full``; beside them ``noskip``.

``tools/kernel_break.py`` and ``tools/surfel_break.py`` time them.  Serving
and training never call them.

``composite_fwd_probe`` and ``surfel_fwd_probe`` take the production
wrappers' inputs (``kernels.composite_fwd``, ``surfel_kernels.surfel_fwd``)
after the variant's name and return the production output's shape, filled
as the variant defines (the headers list what each stage writes):
tensors on the card launch the kernel (or raise), tensors on the CPU take
the plain version.  The plain versions share the production plain
versions' chunked gathers, serial order and rounding and mirror the skips
with ``kernels.subtile_touch`` / ``surfel_kernels.subtile_touch``: the
stages after ``skip`` evaluate only the kept slots, in segment order, so a
kernel and its plain version agree bit for bit; the variants whose output
is the production output use the production plain version itself.  The
sums that a stripped stage writes are the probe's own work: one addition
per evaluation that the stage keeps.  ``composite_work`` /
``surfel_work`` count what each variant does on a scene (stagings,
predicate operations, evaluations, contributions) for its roofline bound.
"""

from __future__ import annotations

import torch

from . import kernels, surfel_kernels
from .kernels import ALPHA_MAX, ALPHA_MIN, CHUNK, OUT_ROWS, SUBTILE, T_EPS

THREADS = 256
BATCH = 256                    # slots staged per batch by the production kernels
# variant names in the order of the CUDA dispatchers' indices, grouped by
# the TPU kernel each replaces
COMPOSITE_VARIANTS = (
    "noop", "load", "skip", "power", "alpha", "trans", "full", "noexit",
    "noskip", "b128", "trips",                       # make_fwd
    "noop_bulk", "full_bulk",                        # make_fwd_hbm
    "tpb2", "tpb4", "tpb2_bulk", "tpb4_bulk",        # make_fwd_tpb
)
SURFEL_VARIANTS = ("noop", "load", "skip", "alpha", "geomd", "trans", "acc", "full",
                   "noskip")
TPU_KERNEL = {v: ("make_fwd_hbm" if v in ("noop_bulk", "full_bulk") else
                  "make_fwd_tpb" if v.startswith("tpb") else "make_fwd")
              for v in COMPOSITE_VARIANTS}
# variants whose output is the production kernel's output, bit for bit
PRODUCTION_OUTPUT = ("full", "noexit", "noskip", "b128", "full_bulk", "tpb2",
                     "tpb4", "tpb2_bulk", "tpb4_bulk")
SURFEL_PRODUCTION_OUTPUT = ("full", "noskip")
# the production rows that the surfel trans / acc stages reach, bit for bit
SURFEL_STAGE_ROWS = {"trans": (12,), "acc": (0, 1, 2, 3, 4, 5, 9, 12)}
# f32 operations of one footprint-skip predicate (subtile_keep) by the way
# it ends: a non-finite entry, a transparent slot, a conic that is not
# positive definite, the bound (and the directional term, where the
# eigenvalue gap is wide enough); of one circle test (circle_keep)
KEEP_OPS = {"nonfinite": 6, "transparent": 7, "not_pd": 13, "bound": 67,
            "directional": 18}
CIRCLE_OPS = {"nonfinite": 3, "test": 19}
# launches per variant (the kernels' totals are in kernels.launch_counts)
variant_launches = {("composite", v): 0 for v in COMPOSITE_VARIANTS}
variant_launches.update({("surfel", v): 0 for v in SURFEL_VARIANTS})


def subtiles_per_cta(variant: str) -> int:
    return int(variant[3]) if variant.startswith("tpb") else 1


def staging_batch(variant: str) -> int:
    return 128 if variant == "b128" else BATCH


def _check_variant(variant, names):
    if variant not in names:
        raise ValueError(f"unknown probe variant {variant!r}; one of {names}")


def composite_fwd_probe(variant: str, table, sorted_ids, tile_starts,
                        tile_counts, tiles_x: int, tiles_y: int,
                        tile_size: int) -> torch.Tensor:
    """The 3DGS forward compositor's probe ``variant``; (T, 5, ts²)."""
    _check_variant(variant, COMPOSITE_VARIANTS)
    num_tiles = tiles_x * tiles_y
    kernels._check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles)
    if table.device.type == "cpu":
        return composite_fwd_probe_plain(variant, table, sorted_ids, tile_starts,
                                         tile_counts, tiles_x, tiles_y, tile_size)
    dev = kernels._check_cuda("composite_fwd_probe", tile_size, table, sorted_ids,
                              tile_starts, tile_counts)
    per_cta = subtiles_per_cta(variant)
    subtiles = num_tiles * (tile_size // SUBTILE) ** 2
    if subtiles % per_cta:
        raise ValueError(f"{variant} needs a multiple of {per_cta} sub-tiles, got "
                         f"{subtiles}")
    out = torch.empty((num_tiles, OUT_ROWS, tile_size * tile_size),
                      dtype=torch.float32, device=dev)
    kernels.launch("composite_fwd_probe", dev, COMPOSITE_VARIANTS.index(variant),
                   table.data_ptr(), sorted_ids.data_ptr(), tile_starts.data_ptr(),
                   tile_counts.data_ptr(), out.data_ptr(), num_tiles, tiles_x, tile_size)
    variant_launches[("composite", variant)] += 1
    return out


def surfel_fwd_probe(variant: str, table, sorted_ids, tile_starts, tile_counts,
                     planes, tiles_x: int, tiles_y: int,
                     tile_size: int) -> torch.Tensor:
    """The 2DGS surfel forward compositor's probe ``variant``; (T, 13, ts²)."""
    _check_variant(variant, SURFEL_VARIANTS)
    num_tiles = tiles_x * tiles_y
    surfel_kernels._check_inputs(table, sorted_ids, tile_starts, tile_counts,
                                 planes, num_tiles)
    if table.device.type == "cpu":
        return surfel_fwd_probe_plain(variant, table, sorted_ids, tile_starts,
                                      tile_counts, planes, tiles_x, tiles_y,
                                      tile_size)
    dev = kernels._check_cuda("surfel_fwd_probe", tile_size, table, sorted_ids,
                              tile_starts, tile_counts, planes)
    out = torch.empty((num_tiles, len(surfel_kernels.FWD_ROWS),
                       tile_size * tile_size), dtype=torch.float32, device=dev)
    kernels.launch("surfel_fwd_probe", dev, SURFEL_VARIANTS.index(variant),
                   table.data_ptr(), sorted_ids.data_ptr(), tile_starts.data_ptr(),
                   tile_counts.data_ptr(), planes.data_ptr(), out.data_ptr(), num_tiles,
                   tiles_x, tile_size)
    variant_launches[("surfel", variant)] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def lane_pixels(tile_size: int, warp_blocks: bool, dev) -> torch.Tensor:
    """(sub-tiles, THREADS): the tile pixel of thread t of each sub-tile's
    CTA, sub-tile q = qy * (ts / 16) + qx.  3DGS: row-major in the
    sub-tile; 2DGS (``warp_blocks``): warp w an 8 x 4 block at column
    (w % 2) * 8, row (w / 2) * 4, lane l at (l % 8, l / 8)."""
    side = tile_size // SUBTILE
    t = torch.arange(THREADS, device=dev)
    if warp_blocks:
        warp, lane = torch.div(t, 32, rounding_mode="floor"), t % 32
        x = (warp % 2) * 8 + lane % 8
        y = torch.div(warp, 2, rounding_mode="floor") * 4 + \
            torch.div(lane, 8, rounding_mode="floor")
    else:
        x, y = t % SUBTILE, torch.div(t, SUBTILE, rounding_mode="floor")
    q = torch.arange(side * side, device=dev)[:, None]
    qx, qy = q % side, torch.div(q, side, rounding_mode="floor")
    return (qy * SUBTILE + y) * tile_size + qx * SUBTILE + x


def _serial_sum(v, width: int):
    """The staged values (..., width) added in order, in f32."""
    s = v[..., 0]
    for q in range(1, width):
        s = s + v[..., q]
    return s


def _staged_checksums(values, width: int, sorted_ids, tile_starts, tile_counts,
                      touch=None):
    """The load and skip stages' checksums: per tile, sub-tile and thread t,
    the sum over the staging batches of the ``width`` staged values of slot
    t of the batch, added in staging order; without ``touch`` every slot of
    the batch at its own index (load: the same for every sub-tile), with it
    the t-th slot that the skip keeps for the sub-tile (skip).  Returns the
    sums (T, sub-tiles, THREADS) and the kept slots (T, sub-tiles).
    ``values(ids)`` gives the staged values (T, BATCH, width) of the slots'
    primitives ``ids`` (T, BATCH)."""
    dev = sorted_ids.device
    num_tiles = tile_starts.shape[0]
    n_sub = 1 if touch is None else touch.shape[0]
    P = sorted_ids.shape[0]
    acc = torch.zeros((num_tiles, n_sub, THREADS + 1), dtype=torch.float32, device=dev)
    kept = torch.zeros((num_tiles, n_sub), dtype=torch.int64, device=dev)
    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    lane = torch.arange(BATCH, device=dev)[None, :]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for base in range(0, max_count, BATCH):
        in_range = (base + lane) < counts                       # (T, BATCH)
        slot = torch.clamp(starts + base + lane, max=max(P - 1, 0))
        s = _serial_sum(values(sorted_ids[slot].long()), width)  # (T, BATCH)
        keep = in_range[:, None] if touch is None else \
            touch[:, slot].permute(1, 0, 2) & in_range[:, None]  # (T, n_sub, BATCH)
        rank = torch.where(keep, torch.cumsum(keep, dim=2) - 1, THREADS)
        src = torch.where(keep, s[:, None], torch.zeros_like(s[:, None]))
        acc.scatter_add_(2, rank, src)          # one addition per kept slot
        kept += keep.sum(dim=2)
    return acc[..., :THREADS], kept


def _at_lanes(out_row, values, pix):
    """Write per-lane values (T, sub-tiles, THREADS), or one value per
    sub-tile CTA (T, sub-tiles), into the tile rows out_row (T, ts²) at
    the lanes' pixels ``pix`` (``lane_pixels``)."""
    if values.dim() == 2:
        values = values[..., None].expand(-1, -1, THREADS)
    for q in range(pix.shape[0]):
        out_row[:, pix[q]] = values[:, q]


def executed_batches(stop, tile_counts, tile_size: int, nb: int):
    """(T, sub-tiles) staging batches a CTA that leaves its segment once
    every pixel is done runs, from each pixel's stop (T, ts²: the segment
    rank of the slot before which it stopped, -1 if it never did): batch b
    runs while any pixel of the sub-tile is alive at its start, so a
    sub-tile whose pixels all stopped, the last at rank s, runs s // nb + 1
    batches; and the assigned batches."""
    q_of_pixel = kernels._subtile_of_pixel(tile_size, stop.device)
    n_sub = (tile_size // SUBTILE) ** 2
    assigned = torch.div(tile_counts.long() + nb - 1, nb, rounding_mode="floor")
    executed = []
    for q in range(n_sub):
        s = stop[:, q_of_pixel == q]
        done = (s >= 0).all(dim=1)
        last = torch.div(s.max(dim=1).values, nb, rounding_mode="floor") + 1
        executed.append(torch.minimum(torch.where(done, last, assigned), assigned))
    return torch.stack(executed, dim=1), assigned[:, None].expand(-1, n_sub)


def _segment_sums(per_slot, tile_starts, m):
    """(T, sub-tiles): the sum of per_slot (sub-tiles or 1, P) over the
    first m[t, q] slots of tile t's segment."""
    csum = torch.nn.functional.pad(torch.cumsum(per_slot.long(), dim=1), (1, 0))
    s = tile_starts.long()[:, None]
    q = torch.arange(m.shape[1], device=m.device)[None, :].expand_as(m)
    q = torch.clamp(q, max=per_slot.shape[0] - 1)
    return csum[q, s + m] - csum[q, s]


def _keep_ops(table, sorted_ids):
    """(1, P) f32 operations of the footprint skip's predicate for each slot
    (``KEEP_OPS``; the way it ends does not depend on the sub-tile), in the
    predicate's f32 arithmetic (``kernels.subtile_keep``)."""
    r = table[sorted_ids.long()]
    a, b, c = r[:, 2], r[:, 3], r[:, 4]
    opa = torch.where(r[:, 10] > 0, r[:, 5], torch.zeros_like(r[:, 5]))
    finite = torch.isfinite(r[:, :5]).all(dim=1) & torch.isfinite(opa)
    det = a * c - b * b
    pd = (a > 0) & (c > 0) & (det > 0)
    m, h = 0.5 * (a + c), 0.5 * (a - c)
    rr = torch.sqrt(h * h + b * b)
    lmax = m + rr
    v1y, v2x = lmax - a, lmax - c
    n1, n2 = b * b + v1y * v1y, v2x * v2x + b * b
    un = torch.sqrt(torch.where(n1 >= n2, n1, n2))
    directional = (rr * 32.0 >= lmax) & (un >= 1e-20)
    K = KEEP_OPS
    ops = torch.where(directional, K["bound"] + K["directional"], K["bound"])
    ops = torch.where(pd, ops, K["not_pd"])
    ops = torch.where(opa <= 0, K["transparent"], ops)
    return torch.where(finite, ops, K["nonfinite"])[None]


def _circle_ops(table, sorted_ids):
    """(1, P) f32 operations of the screen-circle skip's test per slot."""
    r = table[sorted_ids.long()]
    cols = [surfel_kernels.PX, surfel_kernels.PY, surfel_kernels.RAD]
    finite = torch.isfinite(r[:, cols]).all(dim=1)
    return torch.where(finite, CIRCLE_OPS["test"], CIRCLE_OPS["nonfinite"])[None]


def _composite_origins(tiles_x, tiles_y, ts, dev):
    t = torch.arange(tiles_x * tiles_y, device=dev)
    ox = ((t % tiles_x) * ts).to(torch.float32)[:, None]
    oy = (torch.div(t, tiles_x, rounding_mode="floor") * ts).to(torch.float32)[:, None]
    return ox, oy


def composite_fwd_probe_plain(variant: str, table, sorted_ids, tile_starts,
                              tile_counts, tiles_x: int, tiles_y: int,
                              tile_size: int) -> torch.Tensor:
    """Plain PyTorch version of ``composite_fwd_probe``."""
    _check_variant(variant, COMPOSITE_VARIANTS)
    args = (table, sorted_ids, tile_starts, tile_counts, tiles_x, tiles_y, tile_size)
    if variant in PRODUCTION_OUTPUT:
        return kernels.composite_fwd_plain(*args)
    dev = table.device
    num_tiles, npix = tiles_x * tiles_y, tile_size * tile_size
    out = torch.zeros((num_tiles, OUT_ROWS, npix), dtype=torch.float32, device=dev)
    if variant in ("noop", "noop_bulk"):
        return out
    touch = kernels.subtile_touch(*args)
    if variant in ("load", "skip"):
        ox, oy = _composite_origins(tiles_x, tiles_y, tile_size, dev)

        def staged(ids):
            r = table[ids]                                      # (T, BATCH, 12)
            opa = torch.where(r[..., 10] > 0, r[..., 5], torch.zeros_like(r[..., 5]))
            return torch.stack([r[..., 0] - ox, r[..., 1] - oy, r[..., 2], r[..., 3],
                                r[..., 4], opa, r[..., 6], r[..., 7], r[..., 8],
                                r[..., 9]], dim=-1)

        sums, kept = _staged_checksums(staged, 10, sorted_ids, tile_starts,
                                       tile_counts, touch if variant == "skip" else None)
        pix = lane_pixels(tile_size, False, dev)
        _at_lanes(out[:, 0], sums.expand(-1, pix.shape[0], -1), pix)
        if variant == "skip":
            _at_lanes(out[:, 1], kept.to(torch.float32), pix)
        return out
    S, T, stop, _ = composite_chain(variant, *args, touch)
    if variant in ("power", "alpha"):
        out[:, 0] = S
        return out
    out[:, 4] = 1.0 - T
    if variant == "trips":
        executed, assigned = executed_batches(stop, tile_counts, tile_size, BATCH)
        kept = _segment_sums(touch, tile_starts, torch.minimum(
            executed * BATCH, tile_counts.long()[:, None]))
        pix = lane_pixels(tile_size, False, dev)
        for row, v in enumerate((executed, assigned, kept)):
            _at_lanes(out[:, row], v.to(torch.float32), pix)
    return out


def composite_chain(stage, table, sorted_ids, tile_starts, tile_counts,
                    tiles_x, tiles_y, tile_size, touch):
    """``kernels.composite_fwd_plain``'s chunked evaluation over the slots
    that ``touch`` keeps for each pixel's sub-tile, with the stage's own
    consumer: ``power`` / ``alpha`` sum the power form / the alphas past the
    1/255 cull into S; any other stage runs the transmittance chain.
    Returns S, T_final, each pixel's stop (the segment rank of the slot
    before which it stopped, -1 if it never did) and the counts: ``evals``
    (slot, live pixel) pairs and those the skip keeps (``evals_kept``),
    ``hits`` kept pairs past the cull (live or not) and ``contribs``."""
    dev = table.device
    ts = tile_size
    npix = ts * ts
    num_tiles = tiles_x * tiles_y
    f32 = torch.float32
    p = torch.arange(npix, device=dev)
    px = (p % ts).to(f32)
    py = torch.div(p, ts, rounding_mode="floor").to(f32)
    ox, oy = _composite_origins(tiles_x, tiles_y, ts, dev)
    q_of_pixel = kernels._subtile_of_pixel(ts, dev)

    S = torch.zeros((num_tiles, npix), dtype=f32, device=dev)
    T = torch.ones((num_tiles, npix), dtype=f32, device=dev)
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    stop = torch.full((num_tiles, npix), -1, dtype=torch.long, device=dev)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("evals", "evals_kept", "hits", "contribs")}

    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    P = sorted_ids.shape[0]
    k = torch.arange(CHUNK, device=dev)[None, :]
    for c0 in range(0, max_count, CHUNK):
        in_range = (c0 + k) < counts                            # (T, K)
        slot = torch.clamp(starts + c0 + k, max=max(P - 1, 0))
        rows = table[sorted_ids[slot].long()]                   # (T, K, 12)
        kept = kernels._touch_mask(touch, slot, q_of_pixel) & in_range[..., None]
        gx = (rows[..., 0] - ox)[..., None]
        gy = (rows[..., 1] - oy)[..., None]
        a, b, c = (rows[..., i][..., None] for i in (2, 3, 4))
        opa = torch.where(in_range & (rows[..., 10] > 0), rows[..., 5],
                          torch.zeros_like(rows[..., 5]))[..., None]
        dx = px - gx                                            # (T, K, npix)
        dy = py - gy
        power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy,
                            max=0.0)
        alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
        hit = (alpha >= ALPHA_MIN) & kept
        for j in range(min(CHUNK, max_count - c0)):
            live = alive & in_range[:, j:j + 1]
            n["evals"] += live.sum()
            n["evals_kept"] += (live & kept[:, j]).sum()
            n["hits"] += hit[:, j].sum()
            if stage == "power":
                S = torch.where(kept[:, j], S + power[:, j], S)
                continue
            if stage == "alpha":
                S = torch.where(hit[:, j], S + alpha[:, j], S)
                continue
            use = alive & hit[:, j]
            U = T * (1.0 - alpha[:, j])
            stop_here = use & (U < T_EPS)
            alive = alive & ~stop_here
            take = use & ~stop_here
            T = torch.where(take, U, T)
            n["contribs"] += take.sum()
            stop = torch.where(stop_here, c0 + j, stop)
    return S, T, stop, {key: int(v) for key, v in n.items()}


def composite_work(variant: str, chain, table, sorted_ids, tile_starts,
                   tile_counts, tiles_x: int, tiles_y: int,
                   tile_size: int) -> dict:
    """What ``variant`` does on a scene, from ``chain`` (``composite_chain``
    of the ``trans`` stage on it): ``staged`` (slot, CTA) stagings,
    ``predicate_ops`` the skip's f32 operations on them, ``kept`` the
    stagings the skip keeps, ``evals`` the (kept slot, pixel) evaluations,
    ``hits`` those past the cull (alpha) and ``contribs``.  The stages up to
    alpha never stop, so they stage every batch and evaluate every kept
    pair; the others stage the batches that their CTAs run (all of them
    without the exit)."""
    _, _, stop, n = chain
    counts = tile_counts.long()[:, None]
    n_sub = (tile_size // SUBTILE) ** 2
    zero = dict(staged=0, predicate_ops=0, kept=0, evals=0, hits=0, contribs=0)
    if variant in ("noop", "noop_bulk"):
        return zero
    m = counts.expand(-1, n_sub)
    if variant not in ("load", "skip", "power", "alpha", "noexit"):
        nb = staging_batch(variant)
        executed, _ = executed_batches(stop, tile_counts, tile_size, nb)
        m = torch.minimum(executed * nb, m)
    staged = int(m.sum())
    if variant in ("load", "noskip"):
        w = dict(zero, staged=staged, kept=staged)
    else:
        touch = kernels.subtile_touch(table, sorted_ids, tile_starts, tile_counts,
                                      tiles_x, tiles_y, tile_size)
        w = dict(zero, staged=staged,
                 predicate_ops=int(_segment_sums(_keep_ops(table, sorted_ids),
                                                 tile_starts, m).sum()),
                 kept=int(_segment_sums(touch, tile_starts, m).sum()))
    if variant in ("load", "skip"):
        return w
    if variant in ("power", "alpha"):
        return dict(w, evals=w["kept"] * THREADS,
                    hits=n["hits"] if variant == "alpha" else 0)
    return dict(w, evals=n["evals"] if variant == "noskip" else n["evals_kept"],
                contribs=n["contribs"])


def surfel_fwd_probe_plain(variant: str, table, sorted_ids, tile_starts,
                           tile_counts, planes, tiles_x: int, tiles_y: int,
                           tile_size: int) -> torch.Tensor:
    """Plain PyTorch version of ``surfel_fwd_probe``."""
    _check_variant(variant, SURFEL_VARIANTS)
    args = (table, sorted_ids, tile_starts, tile_counts, planes, tiles_x,
            tiles_y, tile_size)
    if variant in SURFEL_PRODUCTION_OUTPUT:
        return surfel_kernels.surfel_fwd_plain(*args)
    dev = table.device
    if variant in SURFEL_STAGE_ROWS:
        # the production chain: its rows that the stage reaches, zeros else
        full = surfel_kernels.surfel_fwd_plain(*args)
        keep = list(SURFEL_STAGE_ROWS[variant])
        out = torch.zeros_like(full)
        out[:, keep] = full[:, keep]
        return out
    num_tiles, npix = tiles_x * tiles_y, tile_size * tile_size
    out = torch.zeros((num_tiles, len(surfel_kernels.FWD_ROWS), npix),
                      dtype=torch.float32, device=dev)
    out[:, 12] = 1.0                                # T, which these never move
    if variant == "noop":
        return out
    touch = surfel_kernels.subtile_touch(table, sorted_ids, tile_starts, tile_counts,
                                         tiles_x, tiles_y, tile_size)
    if variant in ("load", "skip"):
        def staged(ids):
            r = table[ids][..., :20].clone()
            rad = r[..., surfel_kernels.RAD]
            r[..., surfel_kernels.RAD] = rad * rad
            return r

        sums, kept = _staged_checksums(staged, 20, sorted_ids, tile_starts,
                                       tile_counts, touch if variant == "skip" else None)
        pix = lane_pixels(tile_size, True, dev)
        _at_lanes(out[:, 0], sums.expand(-1, pix.shape[0], -1), pix)
        if variant == "skip":
            _at_lanes(out[:, 1], kept.to(torch.float32), pix)
        return out
    S0, S1, _ = surfel_sums(variant, *args, touch)
    out[:, 0] = S0
    out[:, 1] = S1
    return out


def surfel_sums(variant, table, sorted_ids, tile_starts, tile_counts, planes,
                tiles_x, tiles_y, tile_size, touch):
    """The surfel alpha / geomd stages over the slots that ``touch`` keeps
    for each pixel's sub-tile, in segment order: S0 the alphas of the pairs
    that pass the stage's culls (alpha: the circle and 1/255; geomd: also
    z > 0.2), S1 (geomd) their mapped depths; and the counts ``inside``
    (kept pairs inside the circle) and ``hits`` (pairs past the culls)."""
    dev = table.device
    num_tiles, npix = tiles_x * tiles_y, tile_size * tile_size
    X, Y = surfel_kernels._pixel_coords(tiles_x, tiles_y, tile_size, dev)
    q_of_pixel = kernels._subtile_of_pixel(tile_size, dev)
    S0 = torch.zeros((num_tiles, npix), dtype=torch.float32, device=dev)
    S1 = torch.zeros_like(S0)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in ("inside", "hits")}
    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        g = surfel_kernels._chunk_geometry(table, sorted_ids, starts, counts, c0,
                                           X, Y, touch, q_of_pixel)
        if variant == "alpha":
            passed = g["inside"] & (g["alpha"] >= ALPHA_MIN)
        else:
            passed = g["ok"]
            m, _, _ = surfel_kernels._mapped_depth(g["zhit"], planes)
        for j in range(min(CHUNK, max_count - c0)):
            n["inside"] += g["inside"][:, j].sum()
            n["hits"] += passed[:, j].sum()
            S0 = torch.where(passed[:, j], S0 + g["alpha"][:, j], S0)
            if variant == "geomd":
                S1 = torch.where(passed[:, j], S1 + m[:, j], S1)
    return S0, S1, {key: int(v) for key, v in n.items()}


def surfel_chain(table, sorted_ids, tile_starts, tile_counts, planes, tiles_x,
                 tiles_y, tile_size, touch):
    """The production chain over the kept slots (``surfel_kernels``' chunked
    geometry), for the work counts: each pixel's stop (the segment rank of
    the slot before which it stopped, -1 if it never did) and ``evals``
    (slot, live pixel) pairs, those the skip keeps (``evals_kept``), the
    kept pairs inside the circle ``inside`` (of live pixels) and
    ``contribs``."""
    dev = table.device
    num_tiles, npix = tiles_x * tiles_y, tile_size * tile_size
    X, Y = surfel_kernels._pixel_coords(tiles_x, tiles_y, tile_size, dev)
    q_of_pixel = kernels._subtile_of_pixel(tile_size, dev)
    T = torch.ones((num_tiles, npix), dtype=torch.float32, device=dev)
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    stop = torch.full((num_tiles, npix), -1, dtype=torch.long, device=dev)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("evals", "evals_kept", "inside", "contribs")}
    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        g = surfel_kernels._chunk_geometry(table, sorted_ids, starts, counts, c0,
                                           X, Y, touch, q_of_pixel)
        for j in range(min(CHUNK, max_count - c0)):
            surfel_kernels._count_evals(n, alive, g, j)
            use = alive & g["ok"][:, j]
            U = T * (1.0 - g["alpha"][:, j])
            stop_here = use & (U < T_EPS)
            alive = alive & ~stop_here
            take = use & ~stop_here
            T = torch.where(take, U, T)
            n["contribs"] += take.sum()
            stop = torch.where(stop_here, c0 + j, stop)
    return stop, {key: int(v) for key, v in n.items()}


def surfel_work(variant: str, chain, table, sorted_ids, tile_starts, tile_counts,
                planes, tiles_x: int, tiles_y: int, tile_size: int) -> dict:
    """What ``variant`` does on a scene, from ``chain`` (``surfel_chain`` on
    it, with the skip mirrored): ``staged``, ``predicate_ops`` (the circle
    tests of the skip), ``kept``, ``evals`` (circle tests of kept pairs),
    ``inside`` (those inside the circle), ``hits`` (past the stage's culls:
    alpha, geomd) and ``contribs``, as ``composite_work`` counts them."""
    stop, n = chain
    args = (table, sorted_ids, tile_starts, tile_counts, planes, tiles_x, tiles_y,
            tile_size)
    counts = tile_counts.long()[:, None]
    n_sub = (tile_size // SUBTILE) ** 2
    zero = dict(staged=0, predicate_ops=0, kept=0, evals=0, inside=0, hits=0,
                contribs=0)
    if variant == "noop":
        return zero
    m = counts.expand(-1, n_sub)
    if variant not in ("load", "skip", "alpha", "geomd"):
        executed, _ = executed_batches(stop, tile_counts, tile_size, BATCH)
        m = torch.minimum(executed * BATCH, m)
    staged = int(m.sum())
    if variant in ("load", "noskip"):
        w = dict(zero, staged=staged, kept=staged)
    else:
        touch = surfel_kernels.subtile_touch(table, sorted_ids, tile_starts,
                                             tile_counts, tiles_x, tiles_y, tile_size)
        w = dict(zero, staged=staged,
                 predicate_ops=int(_segment_sums(_circle_ops(table, sorted_ids),
                                                 tile_starts, m).sum()),
                 kept=int(_segment_sums(touch, tile_starts, m).sum()))
    if variant in ("load", "skip"):
        return w
    if variant in ("alpha", "geomd"):
        _, _, s = surfel_sums(variant, *args, touch)
        return dict(w, evals=w["kept"] * THREADS, **s)
    return dict(w, evals=n["evals"] if variant == "noskip" else n["evals_kept"],
                inside=n["inside"], contribs=n["contribs"])

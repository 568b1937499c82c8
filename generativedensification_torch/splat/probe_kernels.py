"""The stage probes of the two forward compositors: CUDA kernel wrappers,
launch counts and the plain PyTorch versions.

Replace the TPU probe kernels of the JAX package's
``scripts/dev_kernel_break.py`` (``make_fwd``, ``make_fwd_hbm``,
``make_fwd_tpb``: ``csrc/composite_fwd_probe.cu``) and
``scripts/dev_surfel_break.py`` (``make_fwd``: ``csrc/surfel_fwd_probe.cu``).
Each variant is an instantiation of a compositor body with stages switched
off or another launch shape: for the 3DGS forward the one-CTA-per-tile body
that was the production kernel before the sub-tile redesign
(``csrc/composite_fwd.cuh``; ``full`` is that design whole) and, as
``sub_noexit`` / ``sub_noskip``, the production sub-tile kernel
(``csrc/composite_subtile.cuh``) without its per-sub-tile exit or its
footprint skip; for the surfel forward the one-CTA-per-tile body that was
the production kernel before its sub-tile redesign (``csrc/surfel_fwd.cuh``;
``full`` is that design whole, bitwise the production kernel).
``tools/kernel_break.py`` and
``tools/surfel_break.py`` time them.  Serving and training never call them.

``composite_fwd_probe`` and ``surfel_fwd_probe`` take the production
wrappers' inputs (``kernels.composite_fwd``, ``surfel_kernels.surfel_fwd``)
after the variant's name and return the production output's shape, filled
as the variant defines (the headers list what each stage writes):
tensors on the card launch the kernel (or raise), tensors on the CPU take
the plain version.  The plain versions share the production plain
versions' chunked gathers, serial order and rounding, so a kernel and its
plain version agree bit for bit; the variants whose output is the
production output use the production plain version itself.  The sums that
a stripped stage writes are the probe's own work: one addition per
evaluation that the stage keeps.
"""

from __future__ import annotations

import torch

from . import kernels, surfel_kernels
from .kernels import ALPHA_MAX, ALPHA_MIN, CHUNK, OUT_ROWS, T_EPS, launch_counts

THREADS = 256
BATCH = 256                    # slots staged per batch by the production kernels
# variant names in the order of the CUDA dispatchers' indices, grouped by
# the TPU kernel each replaces
COMPOSITE_VARIANTS = (
    "noop", "load", "power", "alpha", "trans", "full", "full_noexit",
    "full_b128", "trips",                            # make_fwd
    "noop_bulk", "full_bulk",                        # make_fwd_hbm
    "tpb2", "tpb4", "tpb2_bulk", "tpb4_bulk",        # make_fwd_tpb
    "sub_noexit", "sub_noskip",                      # make_fwd (sub-tile body)
)
SURFEL_VARIANTS = ("noop", "load", "alpha", "geomd", "trans", "acc", "full")
TPU_KERNEL = {v: ("make_fwd_hbm" if v in ("noop_bulk", "full_bulk") else
                  "make_fwd_tpb" if v.startswith("tpb") else "make_fwd")
              for v in COMPOSITE_VARIANTS}
# variants whose output is the production kernel's output, bit for bit
PRODUCTION_OUTPUT = ("full", "full_noexit", "full_b128", "full_bulk", "tpb2",
                     "tpb4", "tpb2_bulk", "tpb4_bulk", "sub_noexit", "sub_noskip")
# launches per variant (the kernels' totals are in kernels.launch_counts)
variant_launches = {("composite", v): 0 for v in COMPOSITE_VARIANTS}
variant_launches.update({("surfel", v): 0 for v in SURFEL_VARIANTS})


def tiles_per_cta(variant: str) -> int:
    return int(variant[3]) if variant.startswith("tpb") else 1


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
    dev = table.device
    if dev.type == "cpu":
        return composite_fwd_probe_plain(variant, table, sorted_ids, tile_starts,
                                         tile_counts, tiles_x, tiles_y, tile_size)
    if dev.type != "cuda":
        raise ValueError(f"composite_fwd_probe: unsupported device {dev}")
    kernels._check_cuda(tile_size, table, sorted_ids, tile_starts, tile_counts)
    if num_tiles % tiles_per_cta(variant):
        raise ValueError(f"{variant} needs a multiple of {tiles_per_cta(variant)} "
                         f"tiles, got {num_tiles}")
    lib = kernels.build(("composite_fwd_probe",))["composite_fwd_probe"].lib
    out = torch.empty((num_tiles, OUT_ROWS, tile_size * tile_size),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gd_composite_fwd_probe(
            COMPOSITE_VARIANTS.index(variant), table.data_ptr(),
            sorted_ids.data_ptr(), tile_starts.data_ptr(), tile_counts.data_ptr(),
            out.data_ptr(), num_tiles, tiles_x, tile_size,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd_probe {variant} launch failed: "
                           f"CUDA error {err}")
    launch_counts["composite_fwd_probe"] += 1
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
    dev = table.device
    if dev.type == "cpu":
        return surfel_fwd_probe_plain(variant, table, sorted_ids, tile_starts,
                                      tile_counts, planes, tiles_x, tiles_y,
                                      tile_size)
    if dev.type != "cuda":
        raise ValueError(f"surfel_fwd_probe: unsupported device {dev}")
    kernels._check_cuda(tile_size, table, sorted_ids, tile_starts, tile_counts,
                        planes)
    lib = kernels.build(("surfel_fwd_probe",))["surfel_fwd_probe"].lib
    out = torch.empty((num_tiles, len(surfel_kernels.FWD_ROWS),
                       tile_size * tile_size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gd_surfel_fwd_probe(
            SURFEL_VARIANTS.index(variant), table.data_ptr(), sorted_ids.data_ptr(),
            tile_starts.data_ptr(), tile_counts.data_ptr(), planes.data_ptr(),
            out.data_ptr(), num_tiles, tiles_x, tile_size,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"surfel_fwd_probe {variant} launch failed: "
                           f"CUDA error {err}")
    launch_counts["surfel_fwd_probe"] += 1
    variant_launches[("surfel", variant)] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _lane_checksum(values, sorted_ids, tile_starts, tile_counts, width: int):
    """The load stage's checksum: per tile and lane l < THREADS, the sum over
    the staging batches of the ``width`` staged values of the slot at lane l,
    added in staging order.  ``values(ids)`` gives the staged values
    (T, BATCH, width) of the slots' primitives ``ids`` (T, BATCH)."""
    dev = sorted_ids.device
    num_tiles = tile_starts.shape[0]
    P = sorted_ids.shape[0]
    acc = torch.zeros((num_tiles, THREADS), dtype=torch.float32, device=dev)
    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    lane = torch.arange(BATCH, device=dev)[None, :]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for base in range(0, max_count, BATCH):
        in_range = (base + lane) < counts                       # (T, BATCH)
        slot = torch.clamp(starts + base + lane, max=max(P - 1, 0))
        v = values(sorted_ids[slot].long())                     # (T, BATCH, w)
        s = v[..., 0]
        for q in range(1, width):
            s = s + v[..., q]
        acc = torch.where(in_range, acc + s, acc)
    return acc


def _trips(alive, last_stop, tile_counts):
    """Executed and assigned staging batches per tile: a CTA runs batch b
    while any pixel is alive at its start, so a tile whose pixels all
    stopped, the last at slot s, runs s // BATCH + 1 of its batches."""
    assigned = torch.div(tile_counts.long() + BATCH - 1, BATCH, rounding_mode="floor")
    done = ~alive.any(dim=1)
    executed = torch.where(done, torch.div(last_stop, BATCH, rounding_mode="floor") + 1,
                           assigned)
    return torch.minimum(executed, assigned), assigned


def composite_fwd_probe_plain(variant: str, table, sorted_ids, tile_starts,
                              tile_counts, tiles_x: int, tiles_y: int,
                              tile_size: int,
                              stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``composite_fwd_probe``.  ``stats``, if
    given, receives the stage's data-dependent work: ``evals`` (slot, pixel)
    evaluations it keeps (every in-range pair for power and alpha, the live
    ones past them), ``hits`` (pairs past the 1/255 cull, alpha) and
    ``contribs`` (contributing pairs, trans and after)."""
    _check_variant(variant, COMPOSITE_VARIANTS)
    args = (table, sorted_ids, tile_starts, tile_counts, tiles_x, tiles_y, tile_size)
    if variant in PRODUCTION_OUTPUT:
        return kernels.composite_fwd_plain(*args, stats=stats)
    dev = table.device
    num_tiles, npix = tiles_x * tiles_y, tile_size * tile_size
    out = torch.zeros((num_tiles, OUT_ROWS, npix), dtype=torch.float32, device=dev)
    if variant in ("noop", "noop_bulk"):
        return out
    if variant == "load":
        t = torch.arange(num_tiles, device=dev)
        ox = ((t % tiles_x) * tile_size).to(torch.float32)[:, None]
        oy = (torch.div(t, tiles_x, rounding_mode="floor") * tile_size
              ).to(torch.float32)[:, None]

        def staged(ids):
            r = table[ids]                                      # (T, BATCH, 12)
            opa = torch.where(r[..., 10] > 0, r[..., 5], torch.zeros_like(r[..., 5]))
            return torch.stack([r[..., 0] - ox, r[..., 1] - oy, r[..., 2], r[..., 3],
                                r[..., 4], opa, r[..., 6], r[..., 7], r[..., 8],
                                r[..., 9]], dim=-1)

        out[:, 0, :THREADS] = _lane_checksum(staged, sorted_ids, tile_starts,
                                             tile_counts, 10)
        return out
    return _composite_stage_plain(variant, *args, out, stats)


def _composite_stage_plain(stage, table, sorted_ids, tile_starts, tile_counts,
                           tiles_x, tiles_y, tile_size, out, stats):
    """power / alpha / trans / trips: ``kernels.composite_fwd_plain``'s
    chunked evaluation with the stage's own consumer."""
    dev = table.device
    ts = tile_size
    npix = ts * ts
    num_tiles = tiles_x * tiles_y
    f32 = torch.float32
    p = torch.arange(npix, device=dev)
    px = (p % ts).to(f32)
    py = torch.div(p, ts, rounding_mode="floor").to(f32)
    t = torch.arange(num_tiles, device=dev)
    ox = ((t % tiles_x) * ts).to(f32)[:, None]
    oy = (torch.div(t, tiles_x, rounding_mode="floor") * ts).to(f32)[:, None]

    S = torch.zeros((num_tiles, npix), dtype=f32, device=dev)
    T = torch.ones((num_tiles, npix), dtype=f32, device=dev)
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    last_stop = torch.full((num_tiles,), -1, dtype=torch.long, device=dev)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("evals", "hits", "contribs")}

    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    P = sorted_ids.shape[0]
    k = torch.arange(CHUNK, device=dev)[None, :]
    for c0 in range(0, max_count, CHUNK):
        in_range = (c0 + k) < counts                            # (T, K)
        slot = torch.clamp(starts + c0 + k, max=max(P - 1, 0))
        rows = table[sorted_ids[slot].long()]                   # (T, K, 12)
        gx = (rows[..., 0] - ox)[..., None]
        gy = (rows[..., 1] - oy)[..., None]
        a, b, c = (rows[..., i][..., None] for i in (2, 3, 4))
        opa = torch.where(in_range & (rows[..., 10] > 0), rows[..., 5],
                          torch.zeros_like(rows[..., 5]))[..., None]
        dx = px - gx                                            # (T, K, npix)
        dy = py - gy
        power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy,
                            max=0.0)
        if stage != "power":
            alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
            hit = (alpha >= ALPHA_MIN) & in_range[..., None]
        for j in range(min(CHUNK, max_count - c0)):
            live = alive & in_range[:, j:j + 1]
            n["evals"] += live.sum()
            if stage == "power":
                S = torch.where(live, S + power[:, j], S)
                continue
            if stage == "alpha":
                S = torch.where(hit[:, j], S + alpha[:, j], S)
                n["hits"] += hit[:, j].sum()
                continue
            a_j = alpha[:, j]
            use = alive & hit[:, j]
            U = T * (1.0 - a_j)
            stop = use & (U < T_EPS)
            alive = alive & ~stop
            take = use & ~stop
            T = torch.where(take, U, T)
            n["contribs"] += take.sum()
            last_stop = torch.where(stop.any(dim=1), c0 + j, last_stop)
    if stats is not None:
        stats.update({key: int(v) for key, v in n.items()})
    if stage in ("power", "alpha"):
        out[:, 0] = S
        return out
    out[:, 4] = 1.0 - T
    if stage == "trips":
        executed, assigned = _trips(alive, last_stop, tile_counts)
        out[:, 0] = executed.to(torch.float32)[:, None]
        out[:, 1] = assigned.to(torch.float32)[:, None]
    return out


def surfel_fwd_probe_plain(variant: str, table, sorted_ids, tile_starts,
                           tile_counts, planes, tiles_x: int, tiles_y: int,
                           tile_size: int,
                           stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``surfel_fwd_probe``.  ``stats``, if given,
    receives the stage's data-dependent work: ``evals`` (slot, pixel)
    circle tests it keeps, ``inside`` (pairs inside the circle), ``hits``
    (pairs past the stage's culls, alpha and geomd) and ``contribs``
    (contributing pairs, trans and after)."""
    _check_variant(variant, SURFEL_VARIANTS)
    args = (table, sorted_ids, tile_starts, tile_counts, planes, tiles_x,
            tiles_y, tile_size)
    if variant == "full":
        return surfel_kernels.surfel_fwd_plain(*args, stats=stats)
    dev = table.device
    num_tiles, npix = tiles_x * tiles_y, tile_size * tile_size
    rows = len(surfel_kernels.FWD_ROWS)
    if variant in ("trans", "acc"):
        # the production chain: its rows that the stage reaches, zeros else
        full = surfel_kernels.surfel_fwd_plain(*args, stats=stats)
        keep = [12] if variant == "trans" else [0, 1, 2, 3, 4, 5, 9, 12]
        out = torch.zeros_like(full)
        out[:, keep] = full[:, keep]
        return out
    out = torch.zeros((num_tiles, rows, npix), dtype=torch.float32, device=dev)
    out[:, 12] = 1.0                                # T, which these never move
    if variant == "noop":
        return out
    if variant == "load":
        def staged(ids):
            r = table[ids][..., :20].clone()
            rad = r[..., surfel_kernels.RAD]
            r[..., surfel_kernels.RAD] = rad * rad
            return r

        out[:, 0, :THREADS] = _lane_checksum(staged, sorted_ids, tile_starts,
                                             tile_counts, 20)
        return out
    X, Y = surfel_kernels._pixel_coords(tiles_x, tiles_y, tile_size, dev)
    S0 = torch.zeros((num_tiles, npix), dtype=torch.float32, device=dev)
    S1 = torch.zeros_like(S0)
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("evals", "inside", "hits")}
    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        g = surfel_kernels._chunk_geometry(table, sorted_ids, starts, counts, c0,
                                           X, Y)
        if variant == "alpha":
            passed = g["inside"] & (g["alpha"] >= ALPHA_MIN)
        else:
            passed = g["ok"]
            m, _, _ = surfel_kernels._mapped_depth(g["zhit"], planes)
        for j in range(min(CHUNK, max_count - c0)):
            n["evals"] += g["in_range"][:, j].sum() * npix
            n["inside"] += g["inside"][:, j].sum()
            n["hits"] += passed[:, j].sum()
            S0 = torch.where(passed[:, j], S0 + g["alpha"][:, j], S0)
            if variant == "geomd":
                S1 = torch.where(passed[:, j], S1 + m[:, j], S1)
    if stats is not None:
        stats.update({key: int(v) for key, v in n.items()})
    out[:, 0] = S0
    out[:, 1] = S1
    return out

"""Stage breakdown of the 2DGS surfel forward compositor
(``csrc/surfel_fwd.cu``) on the card, from its stage probes.

    python -m generativedensification_torch.tools.surfel_break [stages ...]
        [--scene A|B] [--scales default|free] [--tile-size 32] [--max-tiles 4]
        [--enum-tiles 0] [--max-per-tile 4096] [--device cuda]

The port of the JAX package's ``scripts/dev_surfel_break.py``.  Each stage is
a variant of ``splat/probe_kernels.py::surfel_fwd_probe``, run in the given
order (default: the ladder ``noop load alpha geomd trans acc full``).  For
each stage it prints the median time of ``--reps`` launches (default 20,
CUDA events), the
increment over the stage before, the stage's operation and byte counts from
this scene's data and the bound they give (``timing.bound``).  Every variant
is held bitwise against its plain version, and ``full`` against the
production kernel.

Scene A is the surfel form A′ of ``bench.py``'s scene (``--n`` surfels in a
``--hw``² view, default 131,072 at 512²; ``--scales free`` for the 2-D
scales in [0.004, 0.02] instead of [0.002, 0.01]); scene B is B′, the
262,144 coarse surfels of the full-width 2DGS serving network from seed 0
in view 0.  Runs on the card (``--device`` defaults to CUDA and fails
without one); with ``--device cpu`` it runs the plain versions and times
them with the host clock, which says nothing of the card.
"""

from __future__ import annotations

import json
import sys

import torch

from ..splat import probe_kernels as pk
from ..splat import surfel_kernels
from ..utils.device import resolve_device
from . import scenes, timing
from .kernel_break import _header, _parser, run_stages

LADDER = ("noop", "load", "alpha", "geomd", "trans", "acc", "full")


def stage_cost(variant: str, args, stats: dict) -> dict:
    """Bytes and f32 operations of one probe launch on this data, and the
    bound they give.  Every stage reads the table, the live ids, the
    segment bounds and the planes (noop reads nothing) and writes the
    (T, 13, ts²) output; the operations are those the stage keeps
    (``timing``'s surfel counts), with the probe's own sums: the circle test
    6 per evaluation everywhere; inside the circle alpha 29 (no z) + 1 per
    hit, geomd 31 + 6 per hit (the mapped depth and two sums), trans 31 + 3
    per contribution, acc 31 + 17 per contribution (w, six multiply-adds,
    sum w); the load stage 20 per slot."""
    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    n_tiles = tiles_x * tiles_y
    out_bytes = n_tiles * len(surfel_kernels.FWD_ROWS) * ts * ts * 4
    if variant == "noop":
        return timing.bound(out_bytes, 0)
    live = int(counts.sum())
    n_bytes = table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + 8 + out_bytes
    front = stats.get("evals", 0) * timing.SURFEL_OPS_PER_EVAL
    inside, hits, contribs = (stats.get(k, 0) for k in ("inside", "hits", "contribs"))
    I = timing.SURFEL_OPS_PER_INSIDE
    ops = {"load": live * 20,
           "alpha": front + inside * (I - 2) + hits,
           "geomd": front + inside * I + hits * 6,
           "trans": front + inside * I + contribs * 3,
           "acc": front + inside * I + contribs * 17}.get(
        variant, front + inside * I + contribs * timing.SURFEL_OPS_PER_CONTRIB["fwd"])
    return timing.bound(n_bytes, ops)


def run(argv=None) -> dict:
    """Parse ``argv``, build the scene, print and return the breakdown."""
    ap = _parser(__doc__, LADDER, pk.SURFEL_VARIANTS)
    ap.add_argument("--scales", choices=("default", "free"), default="default",
                    help="the 2-D scale range of scene A")
    a = ap.parse_args(argv)
    bad = [s for s in a.stages if s not in pk.SURFEL_VARIANTS]
    if bad:
        ap.error(f"unknown stages {bad}; choose from {pk.SURFEL_VARIANTS}")
    dev = resolve_device(a.device)
    with torch.inference_mode():
        if a.scene == "A":
            args, si = scenes.surfel_bench_scene(dev, a.scales, a.tile_size,
                                                 a.max_tiles, a.n, a.hw,
                                                 a.max_per_tile, a.enum_tiles)
        else:
            pkg, cam, cfg = scenes.model_view("2dgs", dev)
            args, si = scenes.model_surfels(pkg, cam, cfg, a.tile_size, a.max_tiles,
                                            a.max_per_tile, a.enum_tiles)
        card = _header(dev, a.scene, a.reps)
        ts = args[7]
        print(f"{args[0].shape[0]} surfels, {args[5]}x{args[6]} tiles of {ts} px, "
              f"{int(args[3].sum())} live pairs, overflow {int(si.overflow)}")
        prod = surfel_kernels.surfel_fwd(*args)
        stages = run_stages(pk.surfel_fwd_probe, pk.surfel_fwd_probe_plain, a.stages,
                            args, stage_cost, (("full",), prod), a.reps)
    return dict(card=card, scene=a.scene, scales=a.scales, surfels=args[0].shape[0],
                tile_size=ts, live_pairs=int(args[3].sum()),
                overflow=int(si.overflow), stages=stages)


def main(argv=None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage breakdown of the 3DGS forward compositor (``csrc/composite_fwd.cu``)
on the card, from its stage probes.

    python -m generativedensification_torch.tools.kernel_break [stages ...]
        [--scene A|B] [--tile-size 32] [--max-tiles 4] [--bwd] [--device cuda]

The port of the JAX package's ``scripts/dev_kernel_break.py`` (and, with
``--bwd``, of ``scripts/dev_bwd_break.py``).  Each stage is a variant of
``splat/probe_kernels.py::composite_fwd_probe``, run in the given order
(default: the ladder ``noop load power alpha trans full``; the others are
``full_noexit``, ``full_b128``, ``trips``, ``noop_bulk``, ``full_bulk``,
``tpb2``, ``tpb4``, ``tpb2_bulk``, ``tpb4_bulk``).  For each stage it prints
the median time of ``--reps`` launches (default 20, CUDA events), the increment over the stage
before, the stage's operation and byte counts from this scene's data and
the bound they give (``timing.bound``).  Every variant is held bitwise
against its plain version, and those whose output is the production
kernel's against the production kernel; ``trips`` prints the executed and
assigned staging batches per tile.

Scene A is ``bench.py``'s (``--n`` Gaussians in a ``--hw``² view, default
131,072 at 512²), scene B the 262,144 coarse Gaussians of the full-width
serving network from seed 0 in view 0.  ``--bwd`` times the compositor's
backward path on the same scene in stages instead: the preamble
``_bwd_common``, the backward kernel in each mode, ``slots_to_gaussians``
under the current ``GD_APOS_MODE``, the whole ``composite_backward`` in
each mode, and the cumulative prefixes pre_a-pre_d of the ``noabs``
backward that the train step runs.

Runs on the card (``--device`` defaults to CUDA and fails without one);
with ``--device cpu`` it runs the plain versions and times them with the
host clock, which says nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..splat import composite, kernels
from ..splat import probe_kernels as pk
from ..utils.device import resolve_device
from . import scenes, timing

LADDER = ("noop", "load", "power", "alpha", "trans", "full")
REPS = 20


def stage_cost(variant: str, args, stats: dict) -> dict:
    """Bytes and f32 operations of one probe launch on this data, and the
    bound they give.  Every stage reads the table, the live ids and the
    segment bounds (noop reads nothing) and writes the (T, 5, ts²) output;
    the operations are those the stage keeps (``timing``'s per-evaluation
    and per-contribution counts), with the probe's own sums: power 12 + 1
    per evaluation, alpha 17 per evaluation + 1 per hit, trans and trips 17
    per evaluation + 3 per contribution, the load stage 2 + 10 per slot."""
    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    n_tiles = tiles_x * tiles_y
    out_bytes = n_tiles * kernels.OUT_ROWS * ts * ts * 4
    if variant in ("noop", "noop_bulk"):
        return timing.bound(out_bytes, 0)
    live = int(counts.sum())
    n_bytes = table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + out_bytes
    ev, E = stats.get("evals", 0), timing.OPS_PER_EVAL
    ops = {"load": live * 12,
           "power": ev * 13,
           "alpha": ev * E + stats.get("hits", 0),
           "trans": ev * E + stats.get("contribs", 0) * 3,
           "trips": ev * E + stats.get("contribs", 0) * 3}.get(
        variant, ev * E + stats.get("contribs", 0) * timing.OPS_PER_CONTRIB)
    return timing.bound(n_bytes, ops)


def run_stages(probe, plain, variants, args, cost, production=None,
               reps: int = REPS) -> list[dict]:
    """Time ``probe(variant, *args)`` for each variant in order and hold it
    bitwise against ``plain(variant, *args, stats=...)``; a variant whose
    output is the production output (``production``: the variants and the
    production output) is also held against the production kernel's.
    Prints one line per stage and returns the records."""
    on_card = args[0].device.type == "cuda"
    clock = (lambda f: timing.cuda_ms(f, reps)) if on_card else \
        (lambda f: timing.host_ms(f, reps))
    recs, prev, cache = [], 0.0, {}
    for v in variants:
        # the production-output variants share one plain run
        key = "production" if production is not None and v in production[0] else v
        if key not in cache:
            stats = {}
            cache[key] = (*timing.once(lambda: plain(v, *args, stats=stats), on_card),
                          stats)
        ref, t_plain, stats = cache[key]
        out = probe(v, *args)
        if on_card:
            torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"{v}: kernel differs from its plain version by "
                             f"{float((out - ref).abs().max())}")
        if production is not None and v in production[0] and not torch.equal(
                out, production[1]):
            raise SystemExit(f"{v}: output differs from the production kernel's")
        ms = clock(lambda: probe(v, *args))
        rec = dict(variant=v, ms=ms, delta_ms=ms - prev, plain_ms=t_plain,
                   max_abs_err=float((out - ref).abs().max()), **stats,
                   **cost(v, args, stats))
        if v == "trips":
            executed, assigned = out[:, 0, 0].long(), out[:, 1, 0].long()
            rec.update(executed=int(executed.sum()), assigned=int(assigned.sum()),
                       tiles=int(executed.numel()),
                       tiles_exiting_early=int((executed < assigned).sum()),
                       executed_max=int(executed.max()),
                       executed_median=float(executed.float().median()),
                       assigned_max=int(assigned.max()))
        recs.append(rec)
        prev = ms
        print(f"{v:12s} {ms:8.3f} ms (+{rec['delta_ms']:7.3f})  ops {rec['ops']:.4g}  "
              f"bytes {rec['bytes']:.4g}  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
        if v == "trips":
            print(f"{'':12s} executed {rec['executed']} / assigned {rec['assigned']} "
                  f"staging batches; tiles exiting early "
                  f"{rec['tiles_exiting_early']}/{rec['tiles']}; executed per tile "
                  f"max {rec['executed_max']}, median {rec['executed_median']:g}",
                  flush=True)
    return recs


def bwd_breakdown(args, back, reps: int = REPS) -> list[dict]:
    """The compositor's backward path in stages on one scene, against the
    constant image cotangent of ``scripts/dev_bwd_break.py`` (1 / its size;
    zero alpha and depth cotangents).  The port's backward kernel gathers
    the forward's table itself, so the JAX slab rebuild has no counterpart;
    pre_b adds ``pack_table`` from the table's own columns in its place."""
    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    dims = (tiles_x, tiles_y, ts)
    sorted_ids, sorted_o, depth_order, _, _, n_slots = back
    on_card = table.device.type == "cuda"
    clock = (lambda f: timing.cuda_ms(f, reps)) if on_card else \
        (lambda f: timing.host_ms(f, reps))
    bg = torch.ones(3, device=table.device)
    out = kernels.composite_fwd(*args)
    image, alpha, depth = composite._images(out, bg, *dims)
    cot = (torch.full_like(image, 1.0 / image.numel()), torch.zeros_like(alpha),
           torch.zeros_like(depth))
    gc4, g2, _ = composite._bwd_common(out, bg, cot, *dims)

    def repack():
        return composite.pack_table(table[:, 0:2], table[:, 2:5], table[:, 6:9],
                                    table[:, 5], table[:, 9], table[:, 10])

    def kernel(mode, gc4=gc4, g2=g2):
        return kernels.composite_bwd(table, ids, starts, counts, gc4, g2, *dims, mode)

    steps = [("bwd_common", lambda: composite._bwd_common(out, bg, cot, *dims))]
    for mode in kernels.BWD_ROWS:
        rows = kernel(mode)
        steps += [(f"kernel {mode}", lambda m=mode: kernel(m)),
                  (f"slots_to_gaussians {composite.APOS_MODE} w{rows.shape[1]}",
                   lambda r=rows: composite.slots_to_gaussians(r, sorted_o,
                                                               depth_order, n_slots)),
                  (f"composite_backward {mode}",
                   lambda m=mode: composite.composite_backward(table, out, bg, cot,
                                                               back, dims, m))]

    def pre(level):
        gc4_, g2_, _ = composite._bwd_common(out, bg, cot, *dims)
        if level >= 2:
            repack()
        if level >= 3:
            rows_ = kernel("noabs", gc4_, g2_)
        if level >= 4:
            composite.slots_to_gaussians(rows_, sorted_o, depth_order, n_slots)

    recs, prev = [], 0.0
    for name, fn in steps:
        ms = clock(fn)
        recs.append(dict(stage=name, ms=ms))
        print(f"{name:44s} {ms:8.3f} ms", flush=True)
    for level, name in enumerate(("pre_a", "pre_b", "pre_c", "pre_d"), start=1):
        ms = clock(lambda: pre(level))
        recs.append(dict(stage=name, ms=ms, delta_ms=ms - prev))
        print(f"{name:44s} {ms:8.3f} ms (+{ms - prev:7.3f})", flush=True)
        prev = ms
    return recs


def _parser(doc, ladder, variants):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", default=list(ladder),
                    help=f"variants, in order: {' '.join(variants)}")
    ap.add_argument("--scene", choices=("A", "B"), default="A")
    ap.add_argument("--tile-size", type=int, default=32)
    ap.add_argument("--max-tiles", type=int, default=4)
    ap.add_argument("--n", type=int, default=131072,
                    help="primitives of scene A")
    ap.add_argument("--hw", type=int, default=512, help="image size of scene A")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed launches per stage (the median is printed)")
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    return ap


def _header(dev, scene: str, reps: int) -> str:
    if dev.type == "cuda":
        head = timing.card()
        print(head)
        print(f"scene {scene}; CUDA kernels, median of {reps} launches by CUDA "
              f"events")
    else:
        head = "cpu"
        print(f"scene {scene}; device {dev}: the plain versions, host clock "
              f"(no device time)")
    return head


def run(argv=None) -> dict:
    """Parse ``argv``, build the scene, print and return the breakdown."""
    ap = _parser(__doc__, LADDER, pk.COMPOSITE_VARIANTS)
    ap.add_argument("--bwd", action="store_true",
                    help="time the compositor's backward path instead")
    a = ap.parse_args(argv)
    bad = [s for s in a.stages if s not in pk.COMPOSITE_VARIANTS]
    if bad:
        ap.error(f"unknown stages {bad}; choose from {pk.COMPOSITE_VARIANTS}")
    dev = resolve_device(a.device)
    with torch.inference_mode():
        if a.scene == "A":
            args, overflow, back = scenes.bench_scene(dev, a.tile_size, a.max_tiles,
                                                      a.n, a.hw)
        else:
            pkg, cam, cfg = scenes.model_view("3dgs", dev)
            args, overflow, back = scenes.model_gaussians(pkg, cam, cfg, a.tile_size,
                                                          a.max_tiles)
        card = _header(dev, a.scene, a.reps)
        print(f"{args[0].shape[0]} Gaussians, {args[4]}x{args[5]} tiles of "
              f"{args[6]} px, {int(args[3].sum())} live pairs, overflow {overflow}")
        res = dict(card=card, scene=a.scene, gaussians=args[0].shape[0],
                   tile_size=args[6], live_pairs=int(args[3].sum()), overflow=overflow)
        if a.bwd:
            res["bwd"] = bwd_breakdown(args, back, a.reps)
        else:
            prod = kernels.composite_fwd(*args)
            res["stages"] = run_stages(pk.composite_fwd_probe,
                                       pk.composite_fwd_probe_plain, a.stages, args,
                                       stage_cost, (pk.PRODUCTION_OUTPUT, prod),
                                       a.reps)
    return res


def main(argv=None) -> int:
    res = run(argv)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

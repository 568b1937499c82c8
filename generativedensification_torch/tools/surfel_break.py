"""Stage breakdown of the 2DGS surfel forward compositor
(``csrc/surfel_fwd.cu``) on the card, from its stage probes; the surfel
backward (``csrc/surfel_bwd.cu``); both against a parent's kernels.

    python -m generativedensification_torch.tools.surfel_break [stages ...]
        [--scene A|B] [--scales default|free] [--tile-size 32] [--max-tiles 4]
        [--enum-tiles 0] [--max-per-tile 4096]
        [--bwd [--full-batches 64 128 256] | --parent DIR [--bwd] [--e2e]]
        [--device cuda]

The port of the JAX package's ``scripts/dev_surfel_break.py``.  Each stage is
a variant of ``splat/probe_kernels.py::surfel_fwd_probe``, run in the given
order (default: the ladder ``noop load alpha geomd trans acc full``), all of
the one-CTA-per-tile design (``csrc/surfel_fwd.cuh``) that preceded the
sub-tile kernel.  For each stage it prints the median time of ``--reps``
launches (default 20, CUDA events), the increment over the stage before,
the stage's operation and byte counts from this scene's data and the bound
they give (``timing.bound``).  Every variant is held bitwise against its
plain version, and ``full`` against the production kernel.  Each run prints
the scene's overflow and the share of (slot, sub-tile) pairs and of circle
tests that the kernels' screen-circle skip keeps
(``surfel_kernels.subtile_touch``).

``--bwd`` times the backward kernel #4 in ``full`` and ``selonly`` instead,
on the cotangent and total rows of ``splat/surfel.py::_bwd_rows`` (the
image-MSE cotangent of a seeded image, seeded cotangents on the other five
maps), each held to its plain version (scaled 5e-5 per row) and bitwise
repeatable; ``--full-batches`` also rebuilds ``surfel_bwd.cu`` with each of
the given ``full`` batch sizes (``-DSURFEL_BWD_FULL_BATCH``) and times each
against the production build, in turns.  ``--parent DIR`` builds
``surfel_fwd.cu`` (and with ``--bwd`` ``surfel_bwd.cu``) of a parent
commit's ``csrc/`` (``git archive <parent> generativedensification_torch/csrc``)
with the port's flags and times #3 (and #4 in both modes) against the
current kernels on the scene, in turns (parent, current, current, parent),
each held to the current plain versions (the forward bitwise, the backward
scaled 5e-5 and bitwise repeatable); with ``--e2e`` it then times the 2DGS
serving forward and a 2DGS train micro-step at the warmup budgets on
either side's kernels (``kernel_break.e2e_versus_parent``).  The 2DGS train
step's warmup budgets are ``--max-tiles 16 --enum-tiles 25 --max-per-tile
16384``.

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
from pathlib import Path

import torch

from ..splat import kernels, surfel
from ..splat import probe_kernels as pk
from ..splat import surfel_kernels
from ..splat.composite import mse_image_cotangent
from ..utils.device import resolve_device
from . import scenes, timing
from .kernel_break import (
    _header,
    _in_turns,
    _parent_kernel,
    _parser,
    e2e_versus_parent,
    run_stages,
)

GRAD_ATOL = 5e-5     # per row, after scaling by its max |value|

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


def skip_shares(args) -> dict:
    """The screen-circle skip's kept share of (slot, sub-tile) pairs and of
    the circle tests (the (slot, live pixel) evaluations) on one scene,
    from its PyTorch mirror, and the plain forward's counts."""
    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    touch = surfel_kernels.subtile_touch(table, ids, starts, counts, tiles_x,
                                         tiles_y, ts)
    stats = {}
    surfel_kernels.surfel_fwd_plain(*args, stats=stats, touch=touch)
    live = int(counts.sum())
    return dict(kept_share=float(touch.sum()) / max(1, live * touch.shape[0]),
                evals_kept_share=stats["evals_kept"] / max(1, stats["evals"]),
                **stats)


def bwd_inputs(args, si, gt=None, seed: int = 0) -> dict:
    """Per backward mode, its (cot8, aux5) rows from a forward of the scene:
    the image-MSE cotangent of ``gt`` (a seeded image if None), seeded 1e-7
    cotangents on the other five maps (so that every row of ``full`` is
    exercised)."""
    table = args[0]
    out = surfel_kernels.surfel_fwd(*args)
    bg = torch.ones(3, device=table.device)
    maps = surfel._maps(out, bg, *si.dims)
    g = torch.Generator(device=table.device).manual_seed(seed)
    if gt is None:
        gt = torch.rand(maps[0].shape, generator=g, device=table.device)
    noise = lambda x: 1e-7 * torch.randn(x.shape, generator=g, device=x.device)
    cot = (mse_image_cotangent(maps[0], gt), *(noise(m) for m in maps[1:]))
    return {mode: surfel._bwd_rows(out, bg, cot, si.dims, mode)[:2]
            for mode in surfel_kernels.SURFEL_BWD_ROWS}


def _check_bwd(fn, plain, what: str) -> float:
    """Two launches of ``fn`` bitwise equal and within GRAD_ATOL of
    ``plain`` per row scaled by its max |value|; returns the scaled
    error."""
    a, b = fn(), fn()
    if a.device.type == "cuda":
        torch.cuda.synchronize()
    scale = plain.abs().amax(dim=0).clamp(min=1e-30)
    err = float(((a - plain) / scale).abs().max())
    if not torch.equal(a, b) or not err <= GRAD_ATOL:
        raise SystemExit(f"{what}: repeatable {torch.equal(a, b)}, scaled error {err}")
    return err


def bwd_breakdown(args, si, reps: int, full_batches=()) -> dict:
    """Kernel #4 in each mode on one scene, against its plain version; with
    ``full_batches``, ``full`` rebuilt with each batch size and timed in
    turns against the production build."""
    on_card = args[0].device.type == "cuda"
    clock = (lambda f: timing.cuda_ms(f, reps)) if on_card else \
        (lambda f: timing.host_ms(f, reps))
    rows = bwd_inputs(args, si)
    recs = {}
    for mode, (cot8, aux5) in rows.items():
        bargs = (*args[:5], cot8, aux5, *args[5:])
        plain, plain_ms = timing.once(
            lambda: surfel_kernels.surfel_bwd_plain(*bargs, mode=mode), on_card)
        kernel = lambda m=mode, b=bargs: surfel_kernels.surfel_bwd(*b, mode=m)
        err = _check_bwd(kernel, plain, f"surfel_bwd {mode}")
        recs[mode] = dict(ms=clock(kernel), plain_ms=plain_ms, max_scaled_err=err)
        print(f"{'surfel_bwd ' + mode:22s} {recs[mode]['ms']:8.3f} ms  scaled err "
              f"{err:.3g}", flush=True)
    if full_batches:
        if not on_card:
            raise SystemExit("--full-batches times CUDA builds: it needs the card")
        cot8, aux5 = rows["full"]
        bargs = (*args[:5], cot8, aux5, *args[5:])
        plain = surfel_kernels.surfel_bwd_plain(*bargs, mode="full")
        current = lambda: surfel_kernels.surfel_bwd(*bargs, mode="full")
        recs["full_batches"] = {}
        for nb in full_batches:
            fn = _parent_kernel(kernels._CSRC, "surfel_bwd",
                                (f"SURFEL_BWD_FULL_BATCH={nb}",))
            variant = lambda fn=fn: _launch_bwd(fn, bargs, "full")
            err = _check_bwd(variant, plain, f"surfel_bwd full batch {nb}")
            rec = _in_turns(variant, current, reps)
            rec["max_scaled_err"] = err
            recs["full_batches"][nb] = rec
            print(f"{'full, batch ' + str(nb):22s} {rec['parent_ms']:8.3f} ms  "
                  f"production {rec['current_ms']:8.3f} ms", flush=True)
    return recs


def _launch_fwd(fn, args):
    """(T, 13, ts²) from ``fn``, a ``gd_surfel_fwd`` built elsewhere."""
    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    out = torch.empty((tiles_x * tiles_y, len(surfel_kernels.FWD_ROWS), ts * ts),
                      device=table.device)
    if fn(table.data_ptr(), ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
          planes.data_ptr(), out.data_ptr(), tiles_x * tiles_y, tiles_x, ts,
          torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("surfel_fwd launch failed")
    return out


def _launch_bwd(fn, bargs, mode):
    """(P, rows) from ``fn``, a ``gd_surfel_bwd`` built elsewhere."""
    table, ids, starts, counts, planes, cot8, aux5, tiles_x, tiles_y, ts = bargs
    out = torch.zeros((ids.shape[0], surfel_kernels.SURFEL_BWD_ROWS[mode]),
                      device=table.device)
    if fn(table.data_ptr(), ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
          planes.data_ptr(), cot8.data_ptr(), aux5.data_ptr(), out.data_ptr(),
          tiles_x * tiles_y, tiles_x, ts, surfel_kernels._BWD_MODE_ID[mode],
          torch.cuda.current_stream().cuda_stream):
        raise RuntimeError(f"surfel_bwd {mode} launch failed")
    return out


def versus_parent(args, si, csrc: Path, reps: int, bwd: bool) -> dict:
    """Kernel #3 (and with ``bwd`` #4 in each mode) of the parent's
    ``csrc`` against the current ones on one scene: outputs held to the
    current plain versions, times in turns."""
    fwd = _parent_kernel(csrc, "surfel_fwd")
    ref = surfel_kernels.surfel_fwd_plain(*args)
    parent_fwd = lambda: _launch_fwd(fwd, args)
    current_fwd = lambda: surfel_kernels.surfel_fwd(*args)
    for name, fn in (("parent", parent_fwd), ("current", current_fwd)):
        out = fn()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"surfel_fwd ({name}) differs from its plain version")
    recs = {"surfel_fwd": _in_turns(parent_fwd, current_fwd, reps)}
    modes = surfel_kernels.SURFEL_BWD_ROWS if bwd else ()
    rows = bwd_inputs(args, si) if bwd else {}
    bwd_fn = _parent_kernel(csrc, "surfel_bwd") if bwd else None
    for mode in modes:
        bargs = (*args[:5], *rows[mode], *args[5:])
        plain = surfel_kernels.surfel_bwd_plain(*bargs, mode=mode)
        parent = lambda m=mode, b=bargs: _launch_bwd(bwd_fn, b, m)
        current = lambda m=mode, b=bargs: surfel_kernels.surfel_bwd(*b, mode=m)
        errs = {name: _check_bwd(fn, plain, f"surfel_bwd {mode} ({name})")
                for name, fn in (("parent", parent), ("current", current))}
        rec = _in_turns(parent, current, reps)
        rec.update(max_scaled_err_parent=errs["parent"],
                   max_scaled_err_current=errs["current"])
        recs[f"surfel_bwd {mode}"] = rec
    for name, rec in recs.items():
        print(f"{name:22s} parent {rec['parent_ms']:8.3f} ms  current "
              f"{rec['current_ms']:8.3f} ms  ({rec['speedup']:.2f}x)", flush=True)
    return recs


def run(argv=None) -> dict:
    """Parse ``argv``, build the scene, print and return the breakdown."""
    ap = _parser(__doc__, LADDER, pk.SURFEL_VARIANTS)
    ap.add_argument("--scales", choices=("default", "free"), default="default",
                    help="the 2-D scale range of scene A")
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward kernel #4 in both modes instead")
    ap.add_argument("--full-batches", type=int, nargs="*", default=(),
                    help="with --bwd: full's batch sizes to rebuild and time")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a parent commit's csrc/: time its kernel #3 (and #4 "
                         "with --bwd) against the current ones instead")
    ap.add_argument("--e2e", action="store_true",
                    help="with --parent: also the 2DGS serving forward and "
                         "train micro-step on either side's kernels")
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
        budgets = (a.max_tiles, a.max_per_tile, a.enum_tiles)
        skip = skip_shares(args)
        print(f"{args[0].shape[0]} surfels, {args[5]}x{args[6]} tiles of {ts} px, "
              f"budgets (max_tiles, max_per_tile, enum_tiles) {budgets}, "
              f"{int(args[3].sum())} live pairs, overflow {int(si.overflow)}; the "
              f"skip keeps {skip['kept_share']:.1%} of (slot, sub-tile) pairs and "
              f"{skip['evals_kept_share']:.1%} of circle tests")
        res = dict(card=card, scene=a.scene, scales=a.scales, surfels=args[0].shape[0],
                   tile_size=ts, budgets=budgets, live_pairs=int(args[3].sum()),
                   overflow=int(si.overflow), skip=skip)
        if a.parent is not None:
            if dev.type != "cuda":
                ap.error("--parent times CUDA kernels: it needs the card")
            res["versus_parent"] = versus_parent(args, si, a.parent, a.reps, a.bwd)
            if a.e2e:
                with torch.inference_mode(False):   # the train step needs autograd
                    res["e2e_versus_parent"] = e2e_versus_parent(a.parent, dev,
                                                                 renderer="2dgs")
        elif a.bwd:
            res["bwd"] = bwd_breakdown(args, si, a.reps, a.full_batches)
        else:
            prod = surfel_kernels.surfel_fwd(*args)
            res["stages"] = run_stages(pk.surfel_fwd_probe, pk.surfel_fwd_probe_plain,
                                       a.stages, args, stage_cost, (("full",), prod),
                                       a.reps)
    return res


def main(argv=None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

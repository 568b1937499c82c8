"""Stage breakdown of the 3DGS forward compositor (``csrc/composite_fwd.cu``)
on the card, from its stage probes.

    python -m generativedensification_torch.tools.kernel_break [stages ...]
        [--scene A|B] [--tile-size 32] [--max-tiles 4] [--enum-tiles 0]
        [--max-per-tile 4096] [--bwd | --parent DIR [--e2e]] [--device cuda]
    python -m generativedensification_torch.tools.kernel_break --slots
        [--parent DIR]

The port of the JAX package's ``scripts/dev_kernel_break.py`` (and, with
``--bwd``, of ``scripts/dev_bwd_break.py``).  Each stage is a variant of
``splat/probe_kernels.py::composite_fwd_probe``, an instantiation of the
production sub-tile body of kernel #1 (``csrc/composite_subtile.cuh``), run
in the given order (default: the ladder ``noop load skip power alpha trans
full``; the others are ``noexit`` / ``noskip`` (production without its
per-sub-tile exit / its footprint skip), ``b128`` (128 slots staged per
batch), ``trips``, ``noop_bulk`` / ``full_bulk`` (the output by bulk
asynchronous copies) and ``tpb2`` / ``tpb4`` / ``tpb2_bulk`` /
``tpb4_bulk`` (2 or 4 sub-tiles per CTA)).  The variants and the
production kernel are timed in 5 rounds of alternating order, each the
median of ``--reps`` launches (default 20, CUDA events, each launch
enqueued behind a device spin so that its wrapper's host time is not
counted).  For each stage it
prints the median of its rounds and their range, the increment over the
stage before, the stage's operation and byte counts from this scene's data
and the bound they give (``timing.bound``); then ``full`` beside the
production kernel (their machine code is the same).  Every variant is held bitwise against
its plain version, and those whose output is the production kernel's
against the production kernel; ``trips`` prints the executed and assigned
staging batches and the kept slots per sub-tile CTA.

Scene A is ``bench.py``'s (``--n`` Gaussians in a ``--hw``² view, default
131,072 at 512²), scene B the 262,144 coarse Gaussians of the full-width
serving network from seed 0 in view 0, binned with the serving budgets
(``--max-tiles 4 --max-per-tile 4096``) or others (the 3DGS train step's
warmup budgets are ``--max-tiles 9 --enum-tiles 16 --max-per-tile 8192``).
``--parent DIR`` builds ``composite_fwd.cu`` and ``composite_bwd.cu`` of a
parent commit's ``csrc/`` (``git archive <parent>
generativedensification_torch/csrc``, as ``tools/sass_check.py`` shows) with
the port's flags and times them against the current kernels on the scene,
in turns (parent, current, current, parent), each held to the current plain
versions (the forward bitwise, every backward mode scaled 5e-5 and bitwise
repeatable); with ``--e2e`` it then times the serving forward and a 3DGS
train micro-step at the warmup budgets on either side's kernels, in the
same turns (host clock; median and quartiles of 14 calls a side).  ``--bwd`` times the compositor's
backward path on the same scene in stages instead: the preamble
``_bwd_common``, the backward kernel in each mode, ``slots_to_gaussians``
under the current ``GD_APOS_MODE``, the whole ``composite_backward`` in
each mode, and the cumulative prefixes pre_a-pre_d of the ``noabs``
backward that the train step runs.

``--parent DIR`` also holds kernels #5 (``reduce_slots.cu``) and #6
(``transpose_rows.cu``) of the parent's ``csrc/`` against the current ones at
the train step's shapes (``SLOT_SHAPES``: 3DGS d 9, w 10 / 2, 2DGS d 16, w 19
/ 2, at the 262,144 coarse and the 118,752 fine Gaussians), with the one
PyTorch call that computes the same function, in turns with a cold L2 cache,
each beside its bound, and prints the launch-weighted device ms per train
micro-step of each side, and the host time of one call of either side's C
entry point (the enqueue, no device wait).  ``--slots`` runs only that
comparison (no scene).

Runs on the card (``--device`` defaults to CUDA and fails without one);
with ``--device cpu`` it runs the plain versions and times them with the
host clock, which says nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from ..splat import composite, kernels
from ..splat import probe_kernels as pk
from ..utils.device import resolve_device
from . import scenes, timing

LADDER = ("noop", "load", "skip", "power", "alpha", "trans", "full")
REPS = 20
ROUNDS = 5


def stage_cost(variant: str, args, work: dict) -> dict:
    """Bytes and f32 operations of one probe launch on this data
    (``work``: ``probe_kernels.composite_work``), and the bound they give.
    Every stage reads the table, the live ids and the segment bounds (noop
    reads nothing) and writes the (T, 5, ts²) output.  The operations are
    those the stage keeps, per (slot, sub-tile CTA) staging: load 2 + the
    checksum's 10; from skip on 2 + the predicate's own count
    (``probe_kernels.KEEP_OPS``), skip adding 10 per kept staging; then per
    (kept slot, pixel) evaluation ``timing``'s counts with the probe's own
    sums: power 12 + 1, alpha 17 + 1 per hit, trans and trips 17 + 3 per
    contribution, the production-output variants 17 + 12 per contribution
    (noskip: every slot staged and evaluated, no predicate).  The integer
    work of the compaction and the exit is not counted."""
    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    n_tiles = tiles_x * tiles_y
    out_bytes = n_tiles * kernels.OUT_ROWS * ts * ts * 4
    if variant in ("noop", "noop_bulk"):
        return dict(work, **timing.bound(out_bytes, 0))
    live = int(counts.sum())
    n_bytes = table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + out_bytes
    E = timing.OPS_PER_EVAL
    front = work["staged"] * 2 + work["predicate_ops"]
    ev, contribs = work["evals"], work["contribs"]
    ops = {"load": work["staged"] * 12,
           "skip": front + work["kept"] * 10,
           "power": front + ev * 13,
           "alpha": front + ev * E + work["hits"],
           "trans": front + ev * E + contribs * 3,
           "trips": front + ev * E + contribs * 3}.get(
        variant, front + ev * E + contribs * timing.OPS_PER_CONTRIB)
    return dict(work, **timing.bound(n_bytes, ops))


def run_stages(probe, plain, variants, args, cost, production=None,
               reps: int = REPS, rounds: int = ROUNDS) -> dict:
    """Hold ``probe(variant, *args)`` bitwise against ``plain(variant,
    *args)`` for each variant, then time them in ``rounds`` rounds (the
    variants in order, then in reverse, alternating), each the median of
    ``reps`` launches; a variant's time is the median of its rounds, its
    spread their range.  ``cost(variant)`` gives its work and bound.
    ``production`` (the variants whose output is the production output, the
    production kernel's output and a callable that launches it): those
    variants are also held against the production output, and the
    production kernel is timed in the same rounds.  On the card each timed
    launch finds the card busy (``timing.busy``), so the wrappers' host time
    is not counted.  Prints one line per
    stage (its increment over the stage before), then ``full`` beside the
    production kernel, and returns the records (``stages``) and that
    comparison (``full_vs_production``)."""
    on_card = args[0].device.type == "cuda"
    clock = (lambda f: timing.cuda_ms(f, reps, before=timing.busy())) if on_card \
        else (lambda f: timing.host_ms(f, reps))
    recs, cache = {}, {}
    for v in variants:
        # the production-output variants share one plain run
        key = "production" if production is not None and v in production[0] else v
        if key not in cache:
            cache[key] = timing.once(lambda: plain(v, *args), on_card)
        ref, t_plain = cache[key]
        out = probe(v, *args)
        if on_card:
            torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"{v}: kernel differs from its plain version by "
                             f"{float((out - ref).abs().max())}")
        if production is not None and v in production[0] and not torch.equal(
                out, production[1]):
            raise SystemExit(f"{v}: output differs from the production kernel's")
        recs[v] = dict(variant=v, plain_ms=t_plain,
                       max_abs_err=float((out - ref).abs().max()), **cost(v))
        if v == "trips":
            pix = pk.lane_pixels(args[-1], False, out.device)[:, 0]
            executed, assigned, kept = (out[:, r][:, pix].long() for r in range(3))
            recs[v].update(executed=int(executed.sum()), assigned=int(assigned.sum()),
                           kept_stagings=int(kept.sum()), ctas=int(executed.numel()),
                           ctas_exiting_early=int((executed < assigned).sum()),
                           executed_max=int(executed.max()),
                           executed_median=float(executed.float().median()),
                           assigned_max=int(assigned.max()))
    fns = {v: (lambda v=v: probe(v, *args)) for v in recs}
    if production is not None:
        fns["production"] = production[2]
    runs = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            runs[k].append(clock(fns[k]))
    prev = 0.0
    for v, rec in recs.items():
        ms = statistics.median(runs[v])
        rec.update(ms=ms, delta_ms=ms - prev, runs_ms=runs[v])
        prev = ms
        print(f"{v:12s} {ms:8.3f} ms (+{rec['delta_ms']:7.3f}; rounds "
              f"{min(runs[v]):.3f}-{max(runs[v]):.3f})  ops {rec['ops']:.4g}  "
              f"bytes {rec['bytes']:.4g}  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
        if v == "trips":
            print(f"{'':12s} executed {rec['executed']} / assigned {rec['assigned']} "
                  f"staging batches, {rec['kept_stagings']} kept stagings; CTAs "
                  f"exiting early {rec['ctas_exiting_early']}/{rec['ctas']}; "
                  f"executed per CTA max {rec['executed_max']}, median "
                  f"{rec['executed_median']:g}", flush=True)
    res = dict(stages=list(recs.values()))
    if production is not None and "full" in recs:
        t = {k: dict(ms=statistics.median(runs[k]), runs_ms=runs[k])
             for k in ("full", "production")}
        res["full_vs_production"] = t
        print(f"{'full':12s} {t['full']['ms']:8.3f} ms  production "
              f"{t['production']['ms']:8.3f} ms (same rounds; full "
              f"{min(runs['full']):.3f}-{max(runs['full']):.3f}, production "
              f"{min(runs['production']):.3f}-{max(runs['production']):.3f})",
              flush=True)
    return res


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


def _parent_kernel(csrc: Path, name: str, defines: tuple = ()):
    """``gd_<name>`` of ``csrc/<name>.cu`` (a parent commit's sources, or
    the current ones with other ``-D`` ``defines``), built with the port's
    nvcc flags into ``build/parent/`` and loaded with the current wrapper's
    argument types."""
    src = csrc / f"{name}.cu"
    flags = (*kernels.NVCC_FLAGS, *(f"-D{d}" for d in defines))
    body = src.read_bytes() + b"".join(h.read_bytes()
                                       for h in sorted(csrc.glob("*.cuh")))
    tag = hashlib.sha256(body + " ".join(flags).encode()).hexdigest()[:16]
    out = kernels._BUILD_DIR / "parent" / f"{name}_{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), f"gd_{name}")
    fn.argtypes = kernels._libraries[name].argtypes
    fn.restype = ctypes.c_int
    return fn


def _as_built(name: str, fn, call):
    """``call()`` with the launches of ``name`` (a one-kernel source) running
    ``fn``, another build of ``gd_<name>`` (``_parent_kernel``), through
    ``kernels.launch`` in place of the current build."""
    lib = kernels._libraries[name]
    current, lib.lib = lib.lib, SimpleNamespace(**{f"gd_{name}": fn})
    try:
        return call()
    finally:
        lib.lib = current


def _turns(fns: dict, reps: int, before=None) -> dict:
    """Median device ms of each of ``fns`` (label -> callable), timed in
    turns: in order, then in reverse; per label the mean of its two runs."""
    runs = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        runs[k].append(timing.cuda_ms(fns[k], reps, before=before))
    return {k: dict(ms=sum(v) / len(v), runs_ms=v) for k, v in runs.items()}


def _in_turns(parent, current, reps):
    """Median device ms of each, timed parent, current, current, parent."""
    t = _turns({"parent": parent, "current": current}, reps)
    p, c = t["parent"]["runs_ms"], t["current"]["runs_ms"]
    return dict(parent_ms=t["parent"]["ms"], current_ms=t["current"]["ms"],
                parent_runs_ms=p, current_runs_ms=c, speedup=sum(p) / sum(c))


# ---------------------------------------------------------------------------
# kernels #5 (reduce_slots) and #6 (transpose_rows)
# ---------------------------------------------------------------------------

# the train step's launches of #5 / #6 per micro-step under GD_APOS_MODE
# gauss / gauss_dsum_col, per renderer: (gaussians, slots per gaussian d at
# the warmup budgets, width w, launches); the 4 selection backwards (w 2) run
# on the coarse gaussians, the 16 compositor backwards (3DGS noabs w 10,
# 2DGS full w 19) on the 8 coarse and the 8 fine renders (the training
# configuration's fine union: 118,752, as chip_smoke.py's train phases
# capture it)
SLOT_SHAPES = {"3dgs": ((262_144, 9, 10, 8), (118_752, 9, 10, 8),
                        (262_144, 9, 2, 4)),
               "2dgs": ((262_144, 16, 19, 8), (118_752, 16, 19, 8),
                        (262_144, 16, 2, 4))}

# inputs on which #5 / #6 must equal their plain versions bit for bit:
# label -> (n, d, w, offset, special) for #5, rows (n*d, w); label -> (w, M,
# offset, special) for #6, cols (w, M).  Each is a contiguous view starting
# ``offset`` floats into its buffer (one row in, or one float in: a base that
# is not 16 B aligned); ``special`` sprinkles NaN, +inf and -inf.  The
# ``grid_`` cases cross every templated width (and w 40 for #6) with a
# full-size and a small ragged shape (n 1,000 at d 4; M 1,001, not a
# multiple of 4), but for the train step's own shapes.  ``ring_48k`` gives #5 a ring of exactly 48 KB, where the
# static barriers need the raised limit too; the ``row_groups`` cases give
# #6 a w too wide for one tile.
_TRAIN_NDW = {(n, d, w) for shapes in SLOT_SHAPES.values() for n, d, w, _ in shapes}
REDUCE_CASES = {
    **{f"train_{r}_n{n}_d{d}_w{w}": (n, d, w, 0, False)
       for r, shapes in SLOT_SHAPES.items() for n, d, w, _ in shapes},
    **{f"grid_n{n}_d{d}_w{w}": (n, d, w, 0, False)
       for n, d in ((262_144, 9), (1_000, 4)) for w in (2, 10, 12, 19)
       if (n, d, w) not in _TRAIN_NDW},
    "row_offset_w10": (262_144, 9, 10, 10, False),
    "row_offset_w19": (118_752, 16, 19, 19, False),
    "ragged_n": (12_347, 9, 10, 0, False),
    "d1": (5_003, 1, 10, 0, False),
    "w7": (12_347, 9, 7, 0, False),
    "ring_48k": (1_000, 16, 48, 0, False),
    "nan_inf": (4_099, 9, 10, 0, True),
}
TRANSPOSE_CASES = {
    **{f"train_w{w}_M{n}": (w, n, 0, False)
       for shapes in SLOT_SHAPES.values() for n, _, w, _ in shapes},
    **{f"grid_w{w}_M{M}": (w, M, 0, False)
       for M in (262_144, 1_001) for w in (2, 10, 12, 19, 40)
       if (M, w) not in {(n, w) for n, _, w in _TRAIN_NDW}},
    "float_offset": (10, 262_144, 1, False),
    "row_offset_ragged_M": (19, 1_001, 1_001, False),
    "ragged_M": (10, 262_145, 0, False),
    "w7": (7, 12_347, 0, False),
    "w512_row_groups": (512, 5_000, 0, False),
    "w600_row_groups_offset": (600, 3_001, 1, False),
    "nan_inf": (10, 4_100, 0, True),
}


def _slot_tensor(shape, offset: int, special: bool, seed: int, dev):
    """A seeded contiguous (rows, cols) view ``offset`` floats into its
    buffer: normal values, 30% of the rows zero (dead slots), and with
    ``special`` 1% each NaN, +inf and -inf."""
    g = torch.Generator(device=dev).manual_seed(seed)
    numel = shape[0] * shape[1]
    buf = torch.randn(offset + numel, generator=g, device=dev)
    x = buf[offset:].view(shape)
    x[torch.rand(shape[0], generator=g, device=dev) < 0.3] = 0.0
    if special:
        u = torch.rand(shape, generator=g, device=dev)
        x[u < 0.01] = float("nan")
        x[(u >= 0.01) & (u < 0.02)] = float("inf")
        x[(u >= 0.02) & (u < 0.03)] = float("-inf")
    return x


def reduce_case(label: str, dev, seed: int = 0):
    """``(rows, n, d)`` of ``REDUCE_CASES[label]``."""
    n, d, w, offset, special = REDUCE_CASES[label]
    return _slot_tensor((n * d, w), offset, special, seed, dev), n, d


def transpose_case(label: str, dev, seed: int = 0):
    """``cols`` of ``TRANSPOSE_CASES[label]``."""
    w, M, offset, special = TRANSPOSE_CASES[label]
    return _slot_tensor((w, M), offset, special, seed, dev)


def same_bits(a, b) -> bool:
    """NaN at the same places and every other element bit for bit (the sign
    of a zero included)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(nan_a, nan_b):
        return False
    return torch.equal(a.masked_fill(nan_a, 0).view(torch.int32),
                       b.masked_fill(nan_b, 0).view(torch.int32))


def slot_edge_cases(dev) -> dict:
    """Every case of ``REDUCE_CASES`` and ``TRANSPOSE_CASES`` through the
    wrapper (one launch each) against the plain version; the records, each
    with ``same_bits``."""
    recs = {}
    for label in REDUCE_CASES:
        rows, n, d = reduce_case(label, dev)
        out, ref = kernels.reduce_slots(rows, n, d), kernels.reduce_slots_plain(rows, n, d)
        recs[f"reduce_slots:{label}"] = dict(shape=[n, d, rows.shape[1]],
                                             aligned=rows.data_ptr() % 16 == 0,
                                             same_bits=same_bits(out, ref))
    for label in TRANSPOSE_CASES:
        cols = transpose_case(label, dev)
        out, ref = kernels.transpose_rows(cols), kernels.transpose_rows_plain(cols)
        recs[f"transpose_rows:{label}"] = dict(shape=list(cols.shape),
                                               aligned=cols.data_ptr() % 16 == 0,
                                               same_bits=same_bits(out, ref))
    return recs


def _host_us(fns: dict, calls: int = 200, rounds: int = 5) -> dict:
    """Host microseconds per call of each of ``fns`` (label -> callable
    that enqueues device work): ``calls`` calls back to back without
    waiting for the card, in turns like ``_turns``, ``rounds`` times; per
    label the median of its runs."""
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k in [*fns, *reversed(fns)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[k]()
            runs[k].append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in runs.items()}


def slot_kernels_versus(csrc: Path | None, dev, reps: int = REPS) -> dict:
    """Kernels #5 and #6 at the train step's shapes (``SLOT_SHAPES``): the
    current kernels, the parent's (``csrc``, built with ``_parent_kernel``)
    and the one PyTorch call that computes the same function
    (``view(n, d, w).sum(1)``, ``t().contiguous()``), each held bit for bit
    against the plain version (the library call only timed), timed in turns
    with a cold L2 (``timing.cold_l2``), beside the bound and two
    yardsticks of what no kernel can beat under this protocol: ``floor``, a
    one-float ``fill_`` (launch and timing overhead), and for #6 ``copy``, a
    contiguous device copy of the same bytes; the host time of one launch of
    each side's entry point (``_host_us``: ``kernels.launch`` alone, into a
    preallocated output); then per renderer the launch-weighted device ms per micro-step
    of each side."""
    before = timing.cold_l2(dev)
    libs = kernels.build(kernels.MAIN_KERNELS)
    entry = {}   # name -> side -> the C entry point
    for name in ("reduce_slots", "transpose_rows"):
        entry[name] = {"current": getattr(libs[name].lib, f"gd_{name}")}
        if csrc is not None:
            entry[name]["parent"] = _parent_kernel(csrc, name)
    recs, per_step = {}, {}
    for renderer, shapes in SLOT_SHAPES.items():
        for n, d, w, count in shapes:
            rows = _slot_tensor((n * d, w), 0, False, 0, dev)
            cols = _slot_tensor((w, n), 0, False, 1, dev)
            copy_dst, one = torch.empty_like(cols), torch.empty(1, device=dev)
            host_out = torch.empty(n * w, device=dev)
            for name, args, c_args, plain, library, n_bytes, ops in (
                    ("reduce_slots", (rows, n, d),
                     (rows.data_ptr(), host_out.data_ptr(), n, d, w),
                     kernels.reduce_slots_plain, lambda: rows.view(n, d, w).sum(1),
                     (n * d * w + n * w) * 4, n * (d - 1) * w),
                    ("transpose_rows", (cols,),
                     (cols.data_ptr(), host_out.data_ptr(), w, n),
                     kernels.transpose_rows_plain, lambda: cols.t().contiguous(),
                     2 * w * n * 4, 0)):
                ref = plain(*args)
                wrapper = getattr(kernels, name)
                fns = {k: lambda a=args, f=f: _as_built(name, f, lambda: wrapper(*a))
                       for k, f in entry[name].items()}
                for k, fn in fns.items():
                    out = fn()
                    torch.cuda.synchronize()
                    if not same_bits(out, ref):
                        raise SystemExit(f"{name} ({k}) at n={n} d={d} w={w} differs "
                                         "from its plain version")
                host = _host_us({k: lambda f=f: _as_built(
                    name, f, lambda: kernels.launch(name, rows.device, *c_args))
                    for k, f in entry[name].items()})
                fns["library"] = library
                fns["floor"] = lambda: one.fill_(0.0)
                if name == "transpose_rows":
                    fns["copy"] = lambda: copy_dst.copy_(cols)
                t = _turns(fns, reps, before)
                rec = dict(kernel=name, renderer=renderer, n=n, d=d, w=w,
                           launches_per_micro_step=count,
                           **{f"{k}_ms": v["ms"] for k, v in t.items()},
                           **{f"{k}_runs_ms": v["runs_ms"] for k, v in t.items()},
                           **{f"{k}_host_us": v for k, v in host.items()},
                           **timing.bound(n_bytes, ops))
                recs[f"{name}_{renderer}_n{n}_w{w}"] = rec
                step = per_step.setdefault(f"{name}_{renderer}", {})
                for k, v in t.items():
                    step[k] = step.get(k, 0.0) + count * v["ms"]
                step["bound"] = step.get("bound", 0.0) + count * rec["bound_ms"]
                print(f"{name:15s} {renderer} n {n:7d} d {d:2d} w {w:2d}  " + "  ".join(
                    f"{k} {v['ms']:.4f}" for k, v in t.items())
                    + f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})  host "
                    + "  ".join(f"{k} {v:.2f}" for k, v in host.items()) + " us",
                    flush=True)
    for key, step in per_step.items():
        print(f"{key:22s} per micro-step (launch-weighted ms): " + "  ".join(
            f"{k} {v:.4f}" for k, v in step.items()), flush=True)
    return dict(shapes=recs, per_micro_step=per_step)


def versus_parent(args, csrc: Path, reps: int = REPS) -> dict:
    """Kernels #1 and #2 (each mode) of the parent's ``csrc`` against the
    current ones on one scene: outputs held to the current plain versions,
    times in turns."""
    table, tiles_x, tiles_y, ts = args[0], *args[4:]
    fwd = _parent_kernel(csrc, "composite_fwd")
    bwd = _parent_kernel(csrc, "composite_bwd")
    parent_fwd = lambda: _as_built("composite_fwd", fwd,
                                   lambda: kernels.composite_fwd(*args))
    parent_bwd = lambda gc4, g2, mode: _as_built(
        "composite_bwd", bwd,
        lambda: kernels.composite_bwd(*args[:4], gc4, g2, *args[4:], mode=mode))
    ref = kernels.composite_fwd_plain(*args)
    current_fwd = lambda: kernels.composite_fwd(*args)
    for name, fn in (("parent", parent_fwd), ("current", current_fwd)):
        out = fn()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"composite_fwd ({name}) differs from its plain version")
    recs = {"composite_fwd": _in_turns(parent_fwd, current_fwd, reps)}
    print(f"{'composite_fwd':22s} parent {recs['composite_fwd']['parent_ms']:8.3f} ms  "
          f"current {recs['composite_fwd']['current_ms']:8.3f} ms  "
          f"({recs['composite_fwd']['speedup']:.2f}x)", flush=True)
    bg = torch.ones(3, device=table.device)
    image, alpha, depth = composite._images(ref, bg, tiles_x, tiles_y, ts)
    g = torch.Generator(device=table.device).manual_seed(0)
    noise = lambda x, s: s * torch.randn(x.shape, generator=g, device=x.device)
    cot = (noise(image, 1e-3), noise(alpha, 1e-5), noise(depth, 1e-5))
    gc4, g2, _ = composite._bwd_common(ref, bg, cot, tiles_x, tiles_y, ts)
    for mode in kernels.BWD_ROWS:
        plain = kernels.composite_bwd_plain(*args[:4], gc4, g2, *args[4:], mode=mode)
        scale = plain.abs().amax(dim=0).clamp(min=1e-30)
        current = lambda m=mode: kernels.composite_bwd(*args[:4], gc4, g2, *args[4:],
                                                         mode=m)
        errs = {}
        for name, fn in (("parent", lambda m=mode: parent_bwd(gc4, g2, m)),
                         ("current", current)):
            a, b = fn(), fn()
            torch.cuda.synchronize()
            errs[name] = float(((a - plain) / scale).abs().max())
            if not torch.equal(a, b) or errs[name] > 5e-5:
                raise SystemExit(f"composite_bwd {mode} ({name}): repeatable "
                                 f"{torch.equal(a, b)}, scaled error {errs[name]}")
        rec = _in_turns(lambda m=mode: parent_bwd(gc4, g2, m), current, reps)
        rec.update(max_scaled_err_parent=errs["parent"],
                   max_scaled_err_current=errs["current"])
        recs[f"composite_bwd {mode}"] = rec
        print(f"{'composite_bwd ' + mode:22s} parent {rec['parent_ms']:8.3f} ms  "
              f"current {rec['current_ms']:8.3f} ms  ({rec['speedup']:.2f}x)",
              flush=True)
    return recs


# the compositor kernels of each renderer
RENDERER_KERNELS = {"3dgs": ("composite_fwd", "composite_bwd"),
                    "2dgs": ("surfel_fwd", "surfel_bwd")}


def e2e_versus_parent(csrc: Path, dev, reps: int = 7,
                      renderer: str = "3dgs") -> dict:
    """The serving forward (the full-width network with ``tpu.renderer``
    ``renderer`` from seed 0 on the probe batch, ``with_fine=True``) and a
    train micro-step of that renderer (the training configuration at its
    warmup budgets, accumulation 2; the 2DGS state past micro-step 1000, so
    that its regularizers are on) with the parent's compositor kernels
    (#1 / #2, or #3 / #4) in place of the current ones, in turns (parent,
    current, current, parent), ``reps`` calls per turn after one warm-up:
    host clock around each call and a synchronize; per side the median and
    quartiles of its 2 x ``reps`` calls."""
    from ..config import load_config
    from ..data.synthetic import make_probe_batch
    from ..models.network import Network, NetworkConfig
    from ..train.loss import Losses
    from ..train.optim import make_optimizer
    from ..train.state import create_train_state
    from ..train.step import make_train_step
    from ..train.train import warmup_budgets

    names = RENDERER_KERNELS[renderer]
    libs = kernels.build(kernels.MAIN_KERNELS)
    sides = {"current": {n: libs[n].lib for n in names},
             "parent": {n: SimpleNamespace(**{f"gd_{n}": _parent_kernel(csrc, n)})
                        for n in names}}
    batch = make_probe_batch(1, 8, 512, 512, n_views=4, seed=0, device=dev)
    net = Network(NetworkConfig.from_config(scenes.fine_config(
        **{"tpu.renderer": renderer})), device=dev, seed=0)
    net.eval()
    tcfg = load_config()
    tcfg.set_dotted("tpu.compute_dtype", "float32")
    tcfg.set_dotted("tpu.renderer", renderer)
    for k, v in warmup_budgets(tcfg).items():
        tcfg.set_dotted(f"tpu.{k}", v)
    tnet = Network(NetworkConfig.from_config(tcfg), device=dev, seed=0)
    opt = make_optimizer(tnet, accumulate=2)
    state = [create_train_state(tnet, opt, seed=0)]
    state[0].step = 1001 if renderer == "2dgs" else 0
    step_fn = make_train_step(tnet, opt, Losses(), with_fine=True)

    def serve():
        with torch.no_grad():
            net(batch, with_fine=True)

    def train():
        state[0], _ = step_fn(state[0], batch)

    def wall_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    runs = {("serving", side): [] for side in sides}
    runs.update({("train", side): [] for side in sides})
    try:
        for side in ("parent", "current", "current", "parent"):
            for n in names:
                libs[n].lib = sides[side][n]
            runs[("serving", side)] += wall_ms(serve)
            runs[("train", side)] += wall_ms(train)
    finally:
        for n in names:
            libs[n].lib = sides["current"][n]
    recs = {}
    for what in ("serving", "train"):
        rec = {}
        for side in ("parent", "current"):
            q1, q2, q3 = statistics.quantiles(runs[(what, side)], n=4)
            rec[side] = dict(median_ms=q2, q1_ms=q1, q3_ms=q3,
                             runs_ms=runs[(what, side)])
        recs[what] = rec
        print(f"{what + ' wall':22s} " + "  ".join(
            f"{side} {r['median_ms']:8.2f} ms (quartiles {r['q1_ms']:.2f}-"
            f"{r['q3_ms']:.2f})" for side, r in rec.items()), flush=True)
    return recs


def _parser(doc, ladder, variants):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", default=list(ladder),
                    help=f"variants, in order: {' '.join(variants)}")
    ap.add_argument("--scene", choices=("A", "B"), default="A")
    ap.add_argument("--tile-size", type=int, default=32)
    ap.add_argument("--max-tiles", type=int, default=4)
    ap.add_argument("--enum-tiles", type=int, default=0,
                    help="rect tiles enumerated per primitive (0: max-tiles)")
    ap.add_argument("--max-per-tile", type=int, default=4096)
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
    ap.add_argument("--parent", type=Path, default=None,
                    help="a parent commit's csrc/: time its kernels #1 and #2 "
                         "against the current ones instead")
    ap.add_argument("--e2e", action="store_true",
                    help="with --parent: also the serving forward and a 3DGS "
                         "train micro-step on either side's kernels")
    ap.add_argument("--slots", action="store_true",
                    help="only kernels #5 / #6 at the train step's shapes")
    a = ap.parse_args(argv)
    bad = [s for s in a.stages if s not in pk.COMPOSITE_VARIANTS]
    if bad:
        ap.error(f"unknown stages {bad}; choose from {pk.COMPOSITE_VARIANTS}")
    dev = resolve_device(a.device)
    if a.slots or a.parent is not None:
        if dev.type != "cuda":
            ap.error("--slots / --parent time CUDA kernels: they need the card")
    if a.slots:
        card = timing.card()
        print(card)
        return dict(card=card, slots=slot_kernels_versus(a.parent, dev, a.reps))
    with torch.inference_mode():
        budgets = (a.max_tiles, a.max_per_tile, a.enum_tiles)
        if a.scene == "A":
            args, overflow, back = scenes.bench_scene(dev, a.tile_size, a.max_tiles,
                                                      a.n, a.hw, a.max_per_tile,
                                                      a.enum_tiles)
        else:
            pkg, cam, cfg = scenes.model_view("3dgs", dev)
            args, overflow, back = scenes.model_gaussians(pkg, cam, cfg, a.tile_size,
                                                          *budgets)
        card = _header(dev, a.scene, a.reps)
        print(f"{args[0].shape[0]} Gaussians, {args[4]}x{args[5]} tiles of "
              f"{args[6]} px, budgets (max_tiles, max_per_tile, enum_tiles) "
              f"{budgets}, {int(args[3].sum())} live pairs, overflow {overflow}")
        res = dict(card=card, scene=a.scene, gaussians=args[0].shape[0],
                   tile_size=args[6], budgets=budgets, live_pairs=int(args[3].sum()),
                   overflow=overflow)
        if a.parent is not None:
            res["versus_parent"] = versus_parent(args, a.parent, a.reps)
            res["slots"] = slot_kernels_versus(a.parent, dev, a.reps)
            if a.e2e:
                with torch.inference_mode(False):   # the train step needs autograd
                    res["e2e_versus_parent"] = e2e_versus_parent(a.parent, dev)
        elif a.bwd:
            res["bwd"] = bwd_breakdown(args, back, a.reps)
        else:
            prod = kernels.composite_fwd(*args)
            chain = pk.composite_chain("trans", *args, kernels.subtile_touch(*args))
            res.update(run_stages(
                pk.composite_fwd_probe, pk.composite_fwd_probe_plain, a.stages, args,
                lambda v: stage_cost(v, args, pk.composite_work(v, chain, *args)),
                (pk.PRODUCTION_OUTPUT, prod, lambda: kernels.composite_fwd(*args)),
                a.reps))
    return res


def main(argv=None) -> int:
    res = run(argv)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage breakdown of the 3DGS forward compositor (``csrc/composite_fwd.cu``)
on the card, from its stage probes.

    python -m generativedensification_torch.tools.kernel_break [stages ...]
        [--scene A|B] [--tile-size 32] [--max-tiles 4] [--enum-tiles 0]
        [--max-per-tile 4096] [--bwd | --parent DIR [--e2e]] [--device cuda]

The port of the JAX package's ``scripts/dev_kernel_break.py`` (and, with
``--bwd``, of ``scripts/dev_bwd_break.py``).  Each stage is a variant of
``splat/probe_kernels.py::composite_fwd_probe``, run in the given order
(default: the ladder ``noop load power alpha trans full``; the others are
``full_noexit``, ``full_b128``, ``trips``, ``noop_bulk``, ``full_bulk``,
``tpb2``, ``tpb4``, ``tpb2_bulk``, ``tpb4_bulk``, all of the one-CTA-per-tile
design that preceded the sub-tile kernels, and ``sub_noexit`` /
``sub_noskip``, the production sub-tile kernel without its per-sub-tile exit
or without its footprint skip).  For each stage it prints
the median time of ``--reps`` launches (default 20, CUDA events), the increment over the stage
before, the stage's operation and byte counts from this scene's data and
the bound they give (``timing.bound``).  Every variant is held bitwise
against its plain version, and those whose output is the production
kernel's against the production kernel; ``trips`` prints the executed and
assigned staging batches per tile.

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

Runs on the card (``--device`` defaults to CUDA and fails without one);
with ``--device cpu`` it runs the plain versions and times them with the
host clock, which says nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

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


def _in_turns(parent, current, reps):
    """Median device ms of each, timed parent, current, current, parent."""
    p1, c1 = timing.cuda_ms(parent, reps), timing.cuda_ms(current, reps)
    c2, p2 = timing.cuda_ms(current, reps), timing.cuda_ms(parent, reps)
    return dict(parent_ms=(p1 + p2) / 2, current_ms=(c1 + c2) / 2,
                parent_runs_ms=[p1, p2], current_runs_ms=[c1, c2],
                speedup=(p1 + p2) / (c1 + c2))


def versus_parent(args, csrc: Path, reps: int = REPS) -> dict:
    """Kernels #1 and #2 (each mode) of the parent's ``csrc`` against the
    current ones on one scene: outputs held to the current plain versions,
    times in turns."""
    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    num_tiles, npix = tiles_x * tiles_y, ts * ts
    fwd = _parent_kernel(csrc, "composite_fwd")
    bwd = _parent_kernel(csrc, "composite_bwd")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptrs = (table.data_ptr(), ids.data_ptr(), starts.data_ptr(), counts.data_ptr())

    def parent_fwd():
        out = torch.empty((num_tiles, kernels.OUT_ROWS, npix), device=table.device)
        if fwd(*ptrs, out.data_ptr(), num_tiles, tiles_x, ts, stream()):
            raise RuntimeError("parent composite_fwd launch failed")
        return out

    def parent_bwd(gc4, g2, mode):
        out = torch.zeros((ids.shape[0], kernels.BWD_ROWS[mode]), device=table.device)
        if bwd(*ptrs, gc4.data_ptr(), g2.data_ptr(), out.data_ptr(), num_tiles,
               tiles_x, ts, kernels._BWD_MODE_ID[mode], stream()):
            raise RuntimeError("parent composite_bwd launch failed")
        return out

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


# the train step's warmup budgets (max_tiles, enum_tiles, max_per_tile) per
# renderer (generativedensification_tpu/train/train.py:126-133)
WARMUP_BUDGETS = {"3dgs": (9, 16, 8192), "2dgs": (16, 25, 16384)}
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
    import statistics
    import time
    from types import SimpleNamespace

    from ..config import load_config
    from ..data.synthetic import make_probe_batch
    from ..models.network import Network, NetworkConfig
    from ..train.loss import Losses
    from ..train.optim import make_optimizer
    from ..train.state import create_train_state
    from ..train.step import make_train_step

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
    max_tiles, enum_tiles, max_per_tile = WARMUP_BUDGETS[renderer]
    for k, v in (("tpu.compute_dtype", "float32"), ("tpu.renderer", renderer),
                 ("tpu.max_tiles", max_tiles), ("tpu.enum_tiles", enum_tiles),
                 ("tpu.max_per_tile", max_per_tile), ("tpu.pair_budget", 0.0)):
        tcfg.set_dotted(k, v)
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
    a = ap.parse_args(argv)
    bad = [s for s in a.stages if s not in pk.COMPOSITE_VARIANTS]
    if bad:
        ap.error(f"unknown stages {bad}; choose from {pk.COMPOSITE_VARIANTS}")
    dev = resolve_device(a.device)
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
            if dev.type != "cuda":
                ap.error("--parent times CUDA kernels: it needs the card")
            res["versus_parent"] = versus_parent(args, a.parent, a.reps)
            if a.e2e:
                with torch.inference_mode(False):   # the train step needs autograd
                    res["e2e_versus_parent"] = e2e_versus_parent(a.parent, dev)
        elif a.bwd:
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

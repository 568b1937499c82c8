"""The train runner: a closed loop in one process that trains the program's
network, one micro-step at a time, as ``train/train.py::main`` runs it.

Set-up builds the training step from the program's public functions (the
network with the configuration's model keys and ``train`` overrides,
``make_optimizer``, ``create_train_state``, ``make_train_step``, run under
``network_config`` with the train CLI's overflow warm-up budgets), fills
the weights from the seed, and drives that step through its first two
updates' micro-steps on the window's
own feed: a prefetch thread that makes each micro-step's samples (distinct
scenes from the seed) as a data loader would, handed over with the
program's ``to_device_batch`` as the train CLI hands them over.  The window
goes on with the same step and feed, adds no host sync of its own, and
ends at the first accumulation boundary after its length, with one
synchronize.  A micro-step whose loss or gradient norm is not finite
counts as failed; the step's stats are read after the window.

``correct`` is decided on those first micro-steps (two whole updates),
once the window has closed and the program is freed: the plain reference
(``benchmark/reference``: the network, the loss and ``reference/train/
adamw.py``) trains from the same seed's weights on the same samples and
takes its own two updates.  It draws its random numbers from the program's
generator state before each micro-step (drop-path masks, order shuffles)
and follows the program's discrete choices, the top-k sets and the grid
cells of each serialized point set, recording how far its own differ: in
bf16 the renders' rounding, passed on through the fine stage, puts a few
points in other sets, patches and neighbours.  For the same reason it
takes the program's coarse renders where the fine stage reads them
(straight-through: the values the program's, the gradient its own), and
compares them with its own on every micro-step; and its second update
starts from the program's weights after the first (any difference in the
first update's sign-like steps sets the bf16 forward on another course),
its own first update compared by itself.  Everything else it computes
itself.  The hooks that record the program's choices and coarse renders
check the program's structure as they go (each name they wrap exists;
each forward renders the coarse set with the selection targets, then the
fine set) and raise where it changed, rather than compare the wrong
tensors.  ``compare`` lists the numbers.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import sys
import time
import types

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import counting, scenes, weights
from .serve import PROGRAM, Prefetch, _capture
from .spans import Spans
from .trace import Trace

log = lambda msg: print(msg, file=sys.stderr, flush=True)
# keys of the configuration's ``train`` group that are the loop's and the
# optimizer's, not the network's
LOOP_KEYS = ("batch_size", "accumulate_grad_batches", "lr", "beta1", "beta2",
             "warmup_iters", "weight_decay", "gradient_clip_val", "start_fine")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def _program(name: str):
    return importlib.import_module(f"{PROGRAM}.{name}")


def network_kwargs(config: dict, fields) -> dict:
    """The configuration's model keys with its training overrides."""
    tr = config["train"]
    unknown = sorted((set(config["model"]) | set(tr)) - set(fields) - set(LOOP_KEYS))
    if unknown:
        raise ValueError(f"configuration keys the network does not take: {unknown}")
    if tr["start_fine"] >= 0:
        raise ValueError("the train runner trains the fine stage from step 0")
    kw = {**config["model"], **{k: v for k, v in tr.items() if k in fields}}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


def budgets(config: dict) -> dict:
    """The renders' budgets, handed to the program and to the reference
    alike: the train CLI's overflow warm-up budgets
    (``train/train.py::warmup_budgets``), which its first 2,000 micro-steps
    use."""
    cfg = types.SimpleNamespace(tpu={"renderer": config["model"]["renderer"]})
    return _program("train.train").warmup_budgets(cfg)


def optimizer_kwargs(config: dict) -> dict:
    tr = config["train"]
    return dict(lr=tr["lr"], betas=(tr["beta1"], tr["beta2"]),
                weight_decay=tr["weight_decay"], warmup=tr["warmup_iters"],
                clip=tr["gradient_clip_val"], accumulate=tr["accumulate_grad_batches"])


def micro_batch(traffic: dict, seed: int, stream: int, index: int) -> dict:
    """The host arrays of micro-step ``index``: ``batch`` distinct scenes,
    collated as the CLI's loader collates them."""
    B = traffic["batch"]
    one = dict(traffic, batch=1)
    parts = [scenes.scene(one, seed, stream, B * index + j) for j in range(B)]
    return {k: torch.cat([p[k] for p in parts]).numpy() for k in parts[0]}


def leaf_norms(tensors) -> torch.Tensor:
    """The f64 norm of each tensor, on the host."""
    return torch.stack([t.detach().double().norm() for t in tensors]).cpu()


class Choices:
    """While installed, records the discrete choices a forward makes in
    ``modules`` (the modules that call these functions), in order: the
    top-k index sets ``topk_split`` returns and the grid cells of each point
    set ``serialize_pointset`` serializes.  Raises where none of the
    modules has one of the two names."""

    def __init__(self, *modules):
        self.sets, self.cells, self._undo = [], [], []
        for name, keep in (("topk_split", lambda out: self.sets.append(out[0])),
                           ("serialize_pointset",
                            lambda out: self.cells.append(out.grid_coord))):
            found = [m for m in modules if hasattr(m, name)]
            if not found:
                self.remove()
                raise RuntimeError(f"the program's structure changed: no {name} in "
                                   f"{[m.__name__ for m in modules]} for the check to follow")
            for m in found:
                self._wrap(m, name, keep)

    def _wrap(self, m, name, keep):
        fn = getattr(m, name)

        def run(*a, **k):
            out = fn(*a, **k)
            keep(out)
            return out

        setattr(m, name, run)
        self._undo.append(lambda: setattr(m, name, fn))

    def take(self) -> tuple:
        out = ([s.cpu() for s in self.sets], [c.cpu() for c in self.cells])
        self.sets, self.cells = [], []
        return out

    def remove(self) -> None:
        for undo in self._undo:
            undo()


class Renders:
    """While installed on a network, hands each ``_render_all``'s outputs
    to ``each(stage, out)``, which returns what the forward goes on with;
    ``stage`` is ``coarse`` for the render given the selection targets
    (``sel_gt``) and ``fine`` for one without.  A training forward with
    fused selection renders the coarse set, then the fine set: a forward
    that renders otherwise raises, since the check would then take one
    stage's renders for the other's."""

    def __init__(self, net, each):
        self.net, self.stages = net, []
        fn = getattr(net, "_render_all", None)
        if fn is None:
            raise RuntimeError("the program's render structure changed: the network has "
                               "no _render_all for the check to follow")

        def run(*a, **k):
            sel_gt = k["sel_gt"] if "sel_gt" in k else (a[4] if len(a) > 4 else None)
            stage = "fine" if sel_gt is None else "coarse"
            self.stages.append(stage)
            return each(stage, fn(*a, **k))

        net._render_all = run
        self._hooks = [net.register_forward_pre_hook(lambda *_: self.stages.clear()),
                       net.register_forward_hook(self._check)]

    def _check(self, *_) -> None:
        if self.stages != ["coarse", "fine"]:
            raise RuntimeError(
                f"the program's render structure changed: a forward rendered {self.stages}, "
                "the check follows one coarse render with the selection targets, then one fine")

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        del self.net._render_all


class CoarseMaps(Renders):
    """While installed on a network, records the coarse renders of each
    forward as the fine stage reads them: the images, alpha, depth and the
    selection gradients, on the host."""

    KEYS = ("image", "alpha", "depth", "sel_abs")

    def __init__(self, net):
        self.maps = []
        super().__init__(net, self._keep)

    def _keep(self, stage: str, out: dict) -> dict:
        if stage == "coarse":
            self.maps.append({k: out[k].detach().cpu() for k in self.KEYS if k in out})
        return out

    def take(self) -> list:
        out, self.maps = self.maps, []
        return out


class Program:
    """The program's training step on ``device``, weights from ``seed``:
    ``micro(batch)`` takes one micro-step and returns its stats."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, losses=None):
        nm = _program("models.network")
        tr = config["train"]

        class Seeded(nm.Network):
            def reset_parameters(self, gen):
                """The benchmark fills the weights (``weights.fill``)."""

        fields = [f.name for f in dataclasses.fields(nm.NetworkConfig)]
        with torch.device(device):
            self.net = Seeded(nm.NetworkConfig(**network_kwargs(config, fields)),
                              device=device)
        weights.fill(self.net, seed)
        self.params = list(self.net.parameters())
        self.opt = _program("train.optim").make_optimizer(
            self.net, lr=tr["lr"], beta1=tr["beta1"], beta2=tr["beta2"],
            weight_decay=tr["weight_decay"], warmup_iters=tr["warmup_iters"],
            grad_clip=tr["gradient_clip_val"], accumulate=tr["accumulate_grad_batches"])
        self.state = _program("train.state").create_train_state(
            self.net, self.opt, seed=seed % (1 << 63))
        self.gen = self.state.generator
        step = _program("train.step").make_train_step(
            self.net, self.opt, losses or _program("train.loss").Losses(), with_fine=True)
        cfg_v = dataclasses.replace(self.net.cfg, **budgets(config))
        network_config = _program("train.train").network_config
        self.beta1 = tr["beta1"]
        self.modules = (nm, _program("points.modules"))

        def micro(batch):
            with network_config(self.net, cfg_v):
                self.state, stats = step(self.state, batch)
            return stats

        self.micro = micro

    def first_moments(self) -> list:
        return [self.opt.state[p]["mu"] for p in self.params]


class Reference:
    """The plain reference's training step, weights from ``seed``; its
    generator is seeded as the program's train state seeds its own."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from ..reference.models import network as rn
        from ..reference.points import modules as rm
        from ..reference.train.adamw import AdamW
        from ..reference.train.step import micro_step

        fields = [f.name for f in dataclasses.fields(rn.NetworkConfig)]
        kw = dict(network_kwargs(config, fields), **budgets(config))
        with torch.device(device):
            self.net = rn.Network(rn.NetworkConfig(**kw), device=device)
        weights.fill(self.net, seed)
        self.params = list(self.net.parameters())
        self.opt = AdamW(self.params, **optimizer_kwargs(config))
        self.gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
        self.beta1 = config["train"]["beta1"]
        self.modules = (rn, rm)
        self.steps = 0

        def micro(batch):
            stats = micro_step(self.net, self.opt, batch, self.gen, self.steps)
            self.steps += 1
            return stats

        self.micro = micro

    def first_moments(self) -> list:
        return self.opt.m


def first_steps(side, batch_of, accumulate: int, record: bool = True,
                restart: list | None = None) -> dict:
    """Drive ``side`` (a ``Program`` or a ``Reference``) through two whole
    updates' micro-steps (``2 * accumulate``), ``batch_of(i)`` feeding micro-step
    ``i``, and keep what the check compares and, with ``record``, what the
    reference follows: the generator's state, the top-k sets, the grid
    cells and the coarse renders of each micro-step, and the weights after
    the first update (on the host); each micro-step's loss, and the
    per-leaf norms of the first gradient (from the first moment after the
    first update) and of each update's change.  With ``restart`` (host
    tensors) the second update starts from those weights in place of
    ``side``'s own after the first."""
    params = side.params
    p0 = [p.detach().clone() for p in params]
    rec = Choices(*side.modules) if record else None
    maps = CoarseMaps(side.net) if record else None
    out = {"gens": [], "choices": [], "cells": [], "maps": [], "loss": []}
    try:
        for i in range(2 * accumulate):
            out["gens"].append(side.gen.get_state())
            stats = side.micro(batch_of(i))
            if record:
                sets, cells = rec.take()
                out["choices"].append(sets)
                out["cells"].append(cells)
                out["maps"].append(maps.take())
            out["loss"].append(stats["loss"])
            if i == accumulate - 1:
                out["grad"] = leaf_norms(side.first_moments()) / (1.0 - side.beta1)
                out["change1"] = leaf_norms([p.detach() - q for p, q in zip(params, p0)])
                if restart is not None:
                    with torch.no_grad():
                        for p, q in zip(params, restart):
                            p.copy_(q)
                p0 = [p.detach().clone() for p in params]
                if record:
                    out["weights1"] = [q.cpu() for q in p0]
    finally:
        if record:
            rec.remove()
            maps.remove()
    out["loss"] = torch.stack(out["loss"]).double().cpu()
    out["change2"] = leaf_norms([p.detach() - q for p, q in zip(params, p0)])
    out["names"] = [n for n, _ in side.net.named_parameters()]
    return out


def _map_gap(own: torch.Tensor, theirs: torch.Tensor, relative: bool) -> float:
    """max |program - reference| (over max |reference| where ``relative``)."""
    a, b = theirs.double(), own.detach().double().cpu()
    if a.shape != b.shape or not torch.isfinite(a).all():
        return math.inf
    d = float((a - b).abs().max()) if a.numel() else 0.0
    return d / max(float(b.abs().max()), 1e-300) if relative else d


def follow(ref: Reference, first: dict, batch_of, flops: list | None = None) -> dict:
    """The reference's own first micro-steps on the same samples, with the
    program's generator states, top-k sets and grid cells, the program's
    coarse renders where the fine stage reads them (straight-through: the
    program's values, the reference's own gradient), and for the second
    update the program's weights after the first (the reference's own
    first update is compared by itself).  Besides ``first_steps``'s
    readings: ``sel_gap``, the largest top-k gap (``ops.Replay``: how far
    the program's worst member falls below the reference's own k-th score,
    relative to it); ``grid_moved``, the largest share of a point set that
    the reference's own rounding put in another grid cell (both inf where
    the program made other choices than the reference asks for); and, over
    every micro-step (both sides from the same weights: the seed's, then
    the program's after the first update), ``coarse_maps``, the largest gap
    of the coarse images and alpha (absolute) and depth (relative) from the
    reference's own, and ``sel_abs``, that of the selection gradients
    (relative)."""
    from ..reference.points import ops, structure

    acc = ref.opt.accumulate
    step = {"i": -1}
    gaps, outside, moved, left = [], [], [], 0
    maps_gap = {"coarse_maps": 0.0, "sel_abs": 0.0}

    def batch_at(i):
        step["i"] = i
        ref.gen.set_state(first["gens"][i])
        ops.REPLAY = ops.Replay(first["choices"][i])
        structure.GRID = structure.GridReplay(first["cells"][i])
        return batch_of(i)

    def follow_coarse(stage, own):
        if stage == "fine":
            return own
        theirs = first["maps"][step["i"]][0]
        out = dict(own)
        for key, t in theirs.items():
            name = "sel_abs" if key == "sel_abs" else "coarse_maps"
            maps_gap[name] = max(maps_gap[name], _map_gap(
                own[key], t, relative=key in ("depth", "sel_abs")))
            p = t.to(own[key].device)
            out[key] = p if key == "sel_abs" else own[key] + (p - own[key]).detach()
        return out

    micro = ref.micro

    def replayed(batch):
        nonlocal left
        try:
            if flops is not None and not flops:
                res = []
                flops.append(counting.flops_by_dtype(lambda: res.append(micro(batch))))
                return res[0]
            return micro(batch)
        finally:
            left += len(ops.REPLAY.chosen) + len(structure.GRID.cells)
            gaps.extend(ops.REPLAY.gaps)
            outside.extend(ops.REPLAY.outside)
            moved.extend(structure.GRID.moved)
            ops.REPLAY = structure.GRID = None

    ref.micro = replayed
    renders = Renders(ref.net, follow_coarse)
    try:
        out = first_steps(ref, batch_at, acc, record=False, restart=first["weights1"])
    except RuntimeError as e:
        if "the program" not in str(e):
            raise
        log(f"the reference could not follow the program: {e}")
        return {"sel_gap": math.inf, "grid_moved": math.inf, **maps_gap}
    finally:
        ref.micro = micro
        renders.remove()
    log(f"top-k gaps {[f'{g:.3g}' for g in gaps]}, below the k-th {[f'{o:.3g}' for o in outside]}, "
        f"grid cells moved {[f'{m:.3g}' for m in moved]}, coarse renders {maps_gap}")
    out["sel_gap"] = max(gaps) if gaps and not left else math.inf
    out["grid_moved"] = max(moved) if moved and not left else math.inf
    out.update(maps_gap)
    out["sel_outside"] = max(outside, default=0.0)
    return out


def _gaps(p: torch.Tensor, r: torch.Tensor, keep: torch.Tensor, names: list,
          what: str) -> torch.Tensor:
    """Per leaf among the ``keep`` leaves: |program norm - reference norm|
    over the larger of the reference leaf's norm and the median leaf's."""
    if p.shape != r.shape or not torch.isfinite(p).all():
        return torch.full((1,), math.inf, dtype=torch.float64)
    p, r = p[keep], r[keep]
    if not r.numel():
        return torch.zeros(1, dtype=torch.float64)
    gap = (p - r).abs() / torch.maximum(r, r.median()).clamp(min=1e-300)
    kept = [n for n, k in zip(names, keep.tolist()) if k]
    worst = gap.argsort(descending=True)[:3].tolist()
    log(f"{what}, median leaf gap {float(gap.median()):.3g}, worst leaves: " + ", ".join(
        f"{kept[i]} {float(p[i]):.6g} / {float(r[i]):.6g}" for i in worst))
    return gap


NUMBERS = ("loss", "grad", "update", "update1", "sel_gap", "grid_moved", "coarse_maps",
           "sel_abs")


def compare(first: dict, ref: dict) -> tuple:
    """The numbers compared: ``loss``, the worst micro-step's relative
    error; ``grad``, the worst leaf's ``_gaps`` of the first gradient;
    ``update`` and ``update1``, the worst leaf's ``_gaps`` of the second
    update's change (both sides from the program's weights after the
    first) and of the first update's, leaving out every leaf whose
    reference gradient is under ``STILL_LEAF`` of the median leaf's (the
    first update moves each weight by the warm-up's first rate, 1e-10,
    under half an ulp of most f32 weights: a leaf's change is then a few
    elements, whose rounding reads up to ~1e-2); and ``follow``'s
    ``sel_gap``, ``grid_moved``, ``coarse_maps`` and ``sel_abs``.  Also
    returns, for the readings, the leaf gaps' median and 90th percentile
    and ``sel_outside``."""
    if "loss" not in ref:
        return {k: ref.get(k, math.inf) for k in NUMBERS}, {}
    pl, rl = first["loss"], ref["loss"]
    loss = (float(((pl - rl).abs() / rl.abs().clamp(min=1e-300)).max())
            if torch.isfinite(pl).all() else math.inf)
    every = torch.ones_like(ref["grad"], dtype=torch.bool)
    moved = ref["grad"] >= STILL_LEAF * ref["grad"].median()
    names = ref["names"]
    log(f"losses, program / reference: {pl.tolist()} / {rl.tolist()}")
    gaps = {key: _gaps(first[key], ref[key], keep, names, key)
            for key, keep in (("grad", every), ("change2", moved), ("change1", moved))}
    spread = {f"{key}_q{q}": float(g.quantile(q / 100)) for key, g in gaps.items()
              for q in (50, 90)}
    spread["sel_outside"] = ref["sel_outside"]
    return {"loss": loss, "grad": float(gaps["grad"].max()),
            "update": float(gaps["change2"].max()), "update1": float(gaps["change1"].max()),
            **{k: ref[k] for k in NUMBERS[4:]}}, spread


def reference_batch(traffic: dict, seed: int, device):
    """Micro-step ``i``'s samples on ``device``, made by the benchmark."""
    return lambda i: {k: torch.as_tensor(v).to(device)
                      for k, v in micro_batch(traffic, seed, 0, i).items()}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check(config: dict, traffic: dict, seed: int, device, first: dict,
          flops: list | None = None) -> tuple:
    """``compare``'s numbers and spread for the program's ``first`` steps."""
    ref = Reference(config, traffic, seed, device)
    out = compare(first, follow(ref, first, reference_batch(traffic, seed, device), flops))
    del ref
    _free(device)
    return out


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_process: float) -> dict:
    """One run of a train cell.  Returns the raw readings (the harness turns
    them into the result's metrics)."""
    on_card = device.type == "cuda"
    to_device_batch = _program("data.pipeline").to_device_batch
    acc = config["train"]["accumulate_grad_batches"]
    B = traffic["batch"]
    t_build = time.time()
    prog = Program(config, traffic, seed, device)
    feed = Prefetch(traffic, seed, 0, make=micro_batch)
    t_warm = time.time()
    nxt = lambda _=None: to_device_batch(feed.get()[1], device)
    # set-up: the first micro-steps, through the window's step and feed
    first = first_steps(prog, nxt, acc)
    spans = tr = None
    if trace:
        spans = Spans()
        spans.module("fwd", prog.net)
        spans.function("optim", prog.opt, "step")
        tr = Trace()
    t_from, t_n = traffic["trace_from"], traffic["trace_steps"]
    launches, capture = [], None
    stats, waits = [], []
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_process
    t_start, cpu_start = time.perf_counter(), time.thread_time()
    deadline = t_start + seconds
    i = 0
    while i % acc or time.perf_counter() < deadline:
        t0 = time.perf_counter()
        host = feed.get()[1]
        waits.append(time.perf_counter() - t0)
        if trace and i == t_from:
            tr.start()
        if trace and i == t_from + t_n - 1:
            capture = _capture(launches)
        batch = to_device_batch(host, device)
        if trace:
            spans._open("step")
        s = prog.micro(batch)
        if trace:
            spans._close("step")
            spans.end_request()
        stats.append(torch.stack([s["loss"], s["grad_norm"], s["overflow"]]))
        if capture is not None:
            capture()
            capture = None
        if trace and i == t_from + t_n - 1:
            tr.stop()
        batch = s = None
        i += 1
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    loop_cpu_s = time.thread_time() - cpu_start
    feed.close()
    if trace and tr.prof is not None and tr.window_s == 0.0:
        tr.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    st = torch.stack(stats).double().cpu() if stats else torch.zeros((0, 3))
    failed = int((~torch.isfinite(st[:, :2]).all(1)).sum())
    traced = min(max(i - t_from, 0), t_n)
    readings = {"attempted": i, "failed": failed, "window_s": window_s,
                "samples_per_step": B, "setup_s": setup_s, "memory_peak_bytes": peak,
                "traced_requests": traced, "data_wait_ms": 1e3 * sum(waits) / max(i, 1),
                "pairs_dropped": float(st[t_from:t_from + t_n, 2].sum()) if traced else None}
    if trace:
        spans.remove()
        readings["spans_ms"] = spans.mean_ms()
        readings["trace"] = tr.read() if tr.window_s else None
        readings["launch_costs"] = [(name, *counting.launch_cost(name, a, k))
                                    for name, a, k in launches if name == "composite_bwd"]
        launches.clear()
    del prog, spans
    _free(device)
    t_check = time.perf_counter()
    flops = [] if trace else None
    readings["checks"] = check(config, traffic, seed, device, first, flops)[0]
    if flops:
        readings["flops_by_dtype"] = flops[0]
    log(f"setup {setup_s:.2f} s (to the runner {t_build - t_process:.2f}, network and "
        f"weights {t_warm - t_build:.2f}, first micro-steps {t_process + setup_s - t_warm:.2f}), "
        f"window {window_s:.2f} s (the loop's thread on a CPU {loop_cpu_s:.2f} s of it), "
        f"{i} micro-steps ({failed} failed), "
        f"losses of the checked micro-steps {first['loss'].tolist()}, "
        f"check {time.perf_counter() - t_check:.2f} s")
    return readings


# --------------------------------------------------- readings of the limits


class LowPrecision(TorchDispatchMode):
    """The control's arithmetic: every matrix product and convolution one
    precision below the one the policy states, forward and backward: bf16
    operands rounded to fp8 (e4m3, one scale per tensor, as fp8 training
    scales them), f32 operands to bf16; f64 (the reference compositors'
    chains) is left as it is."""

    OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "convolution_backward")

    @staticmethod
    def _round(t):
        if not torch.is_tensor(t) or not t.is_floating_point():
            return t
        if t.dtype == torch.bfloat16:
            scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
            return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
        if t.dtype == torch.float32:
            return t.to(torch.bfloat16).to(torch.float32)
        return t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket.__name__ in self.OPS:
            args = tuple(self._round(a) for a in args)
        return func(*args, **kwargs)


def readings(config: dict, traffic: dict, seed: int, device, control: bool = False,
             fault: str | None = None) -> dict:
    """The numbers compared on a run of ``seed``'s first micro-steps,
    without a window: of the program, of the program with a ``fault``
    planted (``half``: the last of the batch's samples left out of the loss,
    the mean taken over the rest; ``colour``: the compositor backward's
    colour gradient 5% too large), or (``control``) of the reference
    computed one precision below the policy's (``LowPrecision``) in the
    program's place."""
    acc = config["train"]["accumulate_grad_batches"]
    undo = []
    if control:
        side = Reference(config, traffic, seed, device)
        mode = LowPrecision()
        micro = side.micro

        def low(batch):
            with mode:
                return micro(batch)

        side.micro = low
        batch_of = reference_batch(traffic, seed, device)
    else:
        losses = None
        if fault == "half":
            losses = _half_batch_losses(traffic["batch"])
        elif fault == "colour":
            undo.append(_colour_fault())
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        side = Program(config, traffic, seed, device, losses)
        to_device_batch = _program("data.pipeline").to_device_batch
        batch_of = lambda i: to_device_batch(micro_batch(traffic, seed, 0, i), device)
    try:
        first = first_steps(side, batch_of, acc)
    finally:
        for u in undo:
            u()
    del side
    _free(device)
    nums, spread = check(config, traffic, seed, device, first)
    return {**nums, **spread}


def _half_batch_losses(B: int):
    base = _program("train.loss").Losses
    keep = B - B // 2

    class Half(base):
        def __call__(self, batch, output, step):
            cut = lambda d: {k: v[:keep] if torch.is_tensor(v) and v.dim() and
                             v.shape[0] == B else v for k, v in d.items()}
            return super().__call__(cut(batch), cut(output), step)

    return Half()


def _colour_fault():
    comp = _program("splat.composite")
    real = comp.composite_backward

    def wrong(*a, **k):
        out = list(real(*a, **k))
        out[3] = out[3] * 1.05
        return tuple(out)

    comp.composite_backward = wrong
    return lambda: setattr(comp, "composite_backward", real)

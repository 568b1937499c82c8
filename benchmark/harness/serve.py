"""The serve runner: a closed loop of one client sending reconstructions to
the program's ``Network.forward(batch, with_fine=True)``, one at a time.

A request is handed over as host tensors (the traffic's scene, made by a
prefetch thread from the seed as a data loader would); its latency runs
from the hand-over to the moment its fine images, depth and alpha are on
the host.  Set-up builds the network on the card, fills its weights from
the seed and serves the traffic's warm-up requests (the same shapes).

After the window the program is freed and the plain reference
(``benchmark/reference``) judges a sample of the window's requests drawn
from the seed, stage by stage, from the program's own state: it computes
the coarse primitives from the inputs and renders the program's, takes the
program's top-k choices (recording by how far each falls short of its
own), runs each densifier stage from the program's input to it, computes
the fine union and renders the program's.  The model's discrete steps
(top-k sets, the serialization of moved points) turn rounding into
different sets, so only a comparison that starts each stage from the
program's state can hold the stage to rounding.  ``check`` gives the
numbers compared.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import queue
import sys
import threading
import time

import numpy as np
import torch

from . import counting, scenes, weights
from .spans import Spans
from .trace import Trace

PROGRAM = "generativedensification_torch"
log = lambda msg: print(msg, file=sys.stderr, flush=True)
# the outputs a user gets back on the host
SERVED = ("image_fine", "depth_fine", "acc_map_fine")
# the other outputs the check compares
MAPS = ("image", "depth", "acc_map", "image_fine", "depth_fine", "acc_map_fine",
        "rend_dist", "rend_normal", "depth_normal")
# the compositor wrappers whose launches the kernel rooflines count
LAUNCHES = (("splat.composite", "composite_fwd"), ("splat.composite", "composite_bwd"),
            ("splat.surfel", "surfel_fwd"), ("splat.surfel", "surfel_bwd"))


def network_kwargs(config: dict, fields) -> dict:
    """The configuration's model keys with its serving overrides."""
    kw = {**config["model"], **config["infer"]}
    unknown = sorted(set(kw) - set(fields))
    if unknown:
        raise ValueError(f"configuration keys the network does not take: {unknown}")
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


def build_program(config: dict, seed: int, device):
    """The program's network on ``device``, weights from ``seed``."""
    mod = importlib.import_module(f"{PROGRAM}.models.network")

    class Seeded(mod.Network):
        def reset_parameters(self, gen):
            """The benchmark fills the weights (``weights.fill``)."""

    fields = [f.name for f in dataclasses.fields(mod.NetworkConfig)]
    with torch.device(device):
        net = Seeded(mod.NetworkConfig(**network_kwargs(config, fields)), device=device)
    weights.fill(net, seed)
    return net


def build_reference(config: dict, seed: int, device):
    from ..reference.models.network import Network, NetworkConfig

    fields = [f.name for f in dataclasses.fields(NetworkConfig)]
    with torch.device(device):
        ref = Network(NetworkConfig(**network_kwargs(config, fields)), device=device)
    weights.fill(ref, seed)
    return ref.requires_grad_(False)


class Recorder:
    """While installed on a network, records what its forward decides and
    hands between stages: the top-k index sets its ``topk_split`` returns
    (``modules`` are the modules that call it), in order, and each
    densifier stage's input and outputs."""

    def __init__(self, net, *modules):
        self.choices, self.stages, self._undo = [], [], []
        for m in modules:
            fn = m.topk_split

            def run(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                self.choices.append(out[0])
                return out

            m.topk_split = run
            self._undo.append(lambda m=m, fn=fn: setattr(m, "topk_split", fn))
        for st in net.stages:
            h = st.register_forward_hook(lambda mod, a, o: self.stages.append((a[0], o)))
            self._undo.append(h.remove)

    def remove(self):
        for undo in self._undo:
            undo()


def record_program(net) -> Recorder:
    return Recorder(net, importlib.import_module(f"{PROGRAM}.models.network"),
                    importlib.import_module(f"{PROGRAM}.points.modules"))


def serve(net, batch_host: dict, device) -> tuple:
    """One request: hand-over to host outputs.  Returns (outputs, host,
    whether every served value is finite), the last checked on the device
    before the copies (a host-side scan of the maps cost ~50 ms a request)."""
    batch = scenes.to_device(batch_host, device)
    out = net(batch, with_fine=True)
    finite = torch.stack([torch.isfinite(out[k]).all() for k in SERVED]).all()
    host = {k: out[k].cpu() for k in SERVED}
    return out, host, bool(finite)


def _points_host(ps) -> dict:
    return {f.name: (getattr(ps, f.name).cpu() if torch.is_tensor(getattr(ps, f.name))
                     else getattr(ps, f.name)) for f in dataclasses.fields(ps)}


def stash(out: dict, host: dict, rec: Recorder) -> dict:
    """What the check needs of one request, on the host."""
    cpu = lambda ts: tuple(t.cpu() for t in ts)
    maps = {k: (host[k] if k in host else out[k].cpu()) for k in MAPS if k in out}
    return {"coarse": cpu(out["render_pkg"][0]), "fine": cpu(out["render_pkg"][1]),
            "maps": maps, "choices": [c.cpu() for c in rec.choices],
            "stages": [(_points_host(i), [_points_host(x) for x in o])
                       for i, o in rec.stages]}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (inf where the shapes differ or ``a`` is not
    finite)."""
    a, b = a.double().cpu(), b.double().cpu()
    if a.shape != b.shape or not torch.isfinite(a).all():
        return float("inf")
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) if b.numel() else 0.0


def _points_rel(p: dict, r) -> float:
    """Worst relative error of the float fields of a point set over its
    valid points (inf where the validity differs)."""
    mask = r.mask.cpu()
    if p["mask"].shape != mask.shape or not torch.equal(p["mask"], mask):
        return float("inf")
    worst = 0.0
    for k in ("coord", "feat", "attribute", "prob"):
        pv, rv = p[k], getattr(r, k)
        if pv is None and rv is None:
            continue
        if pv is None or rv is None:
            return float("inf")
        worst = max(worst, _rel(pv[mask], rv.cpu()[mask]))
    return worst


def check(ref, st: dict, batch_host: dict, device, flops: list | None = None) -> dict:
    """The numbers compared for one stashed request."""
    from ..reference.points import ops
    from ..reference.points.structure import PointSet

    batch = scenes.to_device(batch_host, device)
    own, own_stages = {}, {}
    to_ref = lambda d: PointSet(**{k: v.to(device) if torch.is_tensor(v) else v
                                   for k, v in d.items()})

    def follow(stage, tensors):
        own[stage] = tensors
        return tuple(t.to(device) for t in st[stage])

    def stage_in(mod, args):
        own_stages[mod.stage] = [args[0]]
        return (to_ref(st["stages"][mod.stage][0]),) + tuple(args[1:])

    def stage_out(mod, args, out):
        own_stages[mod.stage].append(out)
        return tuple(to_ref(d) for d in st["stages"][mod.stage][1])

    ref.follow = follow
    hooks = [h for s in ref.stages for h in (s.register_forward_pre_hook(stage_in),
                                             s.register_forward_hook(stage_out))]
    ops.REPLAY = ops.Replay(st["choices"])
    try:
        with torch.no_grad():
            outs = []
            run = lambda: outs.append(ref(batch, with_fine=True))
            if flops is not None:
                flops.append(counting.model_flops(run))
            else:
                run()
            out = outs[0]
        left = len(ops.REPLAY.chosen)
        gaps = ops.REPLAY.gaps
    finally:
        ref.follow = None
        ops.REPLAY = None
        for h in hooks:
            h.remove()
    coarse = max(_rel(p, r) for p, r in zip(st["coarse"], own["coarse"]))
    # the fine head and the pool remainder (the densifier's input, the
    # union's unselected rows), then each stage from the program's input
    p_ok, r_ok = st["fine"][5], own["fine"][5].cpu()
    if p_ok.shape != r_ok.shape or not torch.equal(p_ok, r_ok):
        fine = float("inf")
    else:
        fine = max(_rel(p[p_ok], r.cpu()[r_ok])
                   for p, r in zip(st["fine"][:5], own["fine"][:5]))
    fine = max(fine, _points_rel(st["stages"][0][0], own_stages[0][0]))
    dens = 0.0
    for s, (_, outs_p) in enumerate(st["stages"]):
        for p, r in zip(outs_p, own_stages[s][1]):
            dens = max(dens, _points_rel(p, r))
    maps = {}
    for k, p in st["maps"].items():
        r = out[k].cpu()
        if k.startswith("depth") or k == "rend_dist":
            maps[k] = _rel(p, r)                         # depths: relative
        elif p.shape != r.shape or not torch.isfinite(p).all():
            maps[k] = float("inf")
        else:
            maps[k] = float((p.double() - r.double()).abs().max())
    # the depth-derived normals difference neighbouring depths and normalise:
    # 1e-6 of depth rounding reads up to ~1 there at a depth edge, so they
    # are judged from the program's own depth and alpha
    nums = {}
    if "depth_normal" in maps:
        del maps["depth_normal"]
        nums["depth_normal"] = _depth_normal_gap(ref, batch, st["maps"])
    log("render, by map: " + ", ".join(f"{k} {v:.3g}" for k, v in {**maps, **nums}.items()))
    render = max(maps.values())
    gap = max(gaps) if gaps and not left else float("inf")
    return {"prim_coarse": coarse, "prim_fine": fine, "densifier": dens,
            "sel_gap": gap, "render": render, **nums}


def _depth_normal_gap(ref, batch: dict, maps: dict) -> float:
    """max |the program's depth-derived normals - the reference's from the
    program's coarse depth and alpha|, over every view."""
    from ..reference.core.rays import camera_rays
    from ..reference.splat.surfel import depth_to_normal

    B, V, H, W, _ = batch["tar_rgb"].shape
    dev = batch["tar_rgb"].device
    worst = 0.0
    for b, cams in enumerate(ref._cameras_all(batch)):
        for j in range(V):
            cols = slice(j * W, (j + 1) * W)
            want = depth_to_normal(maps["depth"][b, :, cols, 0].to(dev),
                                   camera_rays(cams[j]), maps["acc_map"][b, :, cols].to(dev))
            got = maps["depth_normal"][b, :, cols]
            if not torch.isfinite(got).all():
                return float("inf")
            worst = max(worst, float((got.double() - want.cpu().double()).abs().max()))
    return worst


class Prefetch:
    """A data loader's prefetch thread: makes the requests of one stream
    ahead of the loop (two in flight), each by ``make(traffic, seed,
    stream, index)``."""

    def __init__(self, traffic, seed, stream, make=scenes.scene):
        self.make = make
        self.q = queue.Queue(maxsize=2)
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._run, args=(traffic, seed, stream),
                                  daemon=True)
        self.t.start()

    def _run(self, traffic, seed, stream):
        i = 0
        while not self.stop.is_set():
            item = (i, self.make(traffic, seed, stream, i))
            while not self.stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass
            i += 1

    def get(self):
        return self.q.get()

    def close(self):
        self.stop.set()
        while self.t.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.1)


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_process: float) -> dict:
    """One run of a serve cell.  Returns the raw readings (the harness turns
    them into the result's metrics)."""
    on_card = device.type == "cuda"
    t_build = time.time()
    net = build_program(config, seed, device)
    t_warm = time.time()
    # warm-up: the traffic's own shapes, from a stream of their own
    warm = Prefetch(traffic, seed, 1)
    with torch.no_grad():
        for _ in range(traffic["warmup_requests"]):
            serve(net, warm.get()[1], device)
    warm.close()
    to_check = set(check_sample(traffic, seed))
    spans = tr = None
    if trace:
        spans = Spans()
        nm = importlib.import_module(f"{PROGRAM}.models.network")
        spans.module("encoder", net.img_encoder)
        spans.module("voltx", net.vol_decoder)
        for st_mod in net.stages:
            spans.module("densifier", st_mod)
        spans.function("render", nm, "rasterize_surfels" if net.cfg.renderer == "2dgs"
                       else "rasterize")
        tr = Trace()
    t_from, t_n = traffic["trace_from"], traffic["trace_requests"]
    launches, capture = [], None
    lat, stashed, failed = [], {}, 0
    feed = Prefetch(traffic, seed, 0)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_process
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    with torch.no_grad():
        while time.perf_counter() < deadline:
            idx, batch_host = feed.get()
            if trace and i == t_from:
                tr.start()
            if trace and i == t_from + t_n - 1:
                capture = _capture(launches)
            rec = record_program(net) if idx in to_check else None
            t0 = time.perf_counter()
            try:
                out, host, finite = serve(net, batch_host, device)
            except (RuntimeError, ValueError):
                out, finite = None, False
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if capture is not None:
                capture()
                capture = None
            if trace:
                spans.end_request()
                if i == t_from + t_n - 1:
                    tr.stop()
            failed += not finite
            if rec is not None:
                rec.remove()
                if out is not None:
                    stashed[idx] = stash(out, host, rec)
            out = host = rec = None
            i += 1
    window_s = time.perf_counter() - t_start
    feed.close()
    if trace and tr.prof is not None and tr.window_s == 0.0:
        tr.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    readings = {"attempted": i, "failed": failed, "window_s": window_s,
                "latencies_s": lat, "setup_s": setup_s, "memory_peak_bytes": peak,
                "traced_requests": min(max(i - t_from, 0), t_n)}
    if trace:
        spans.remove()
        readings["spans_ms"] = spans.mean_ms()
        readings["trace"] = tr.read() if tr.window_s else None
        readings["launch_costs"] = [(name, *counting.launch_cost(name, a, k))
                                    for name, a, k in launches]
        launches.clear()
    del net
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = build_reference(config, seed, device)
    worst, flops = {}, ([] if trace else None)
    for idx in sorted(stashed):
        nums = check(ref, stashed[idx], scenes.scene(traffic, seed, 0, idx), device,
                     flops if flops is not None and not flops else None)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    readings["checks"] = worst
    log(f"setup {setup_s:.2f} s (to the runner {t_build - t_process:.2f}, network and "
        f"weights {t_warm - t_build:.2f}, warm-up {t_process + setup_s - t_warm:.2f}), "
        f"window {window_s:.2f} s, {i} requests, "
        f"check of requests {sorted(stashed)} {time.perf_counter() - t_check:.2f} s")
    if flops:
        readings["flops_per_request"] = flops[0]
    return readings


def _capture(launches: list):
    """Record the arguments of every compositor launch until the returned
    function is called."""
    undo = []
    for modname, attr in LAUNCHES:
        m = importlib.import_module(f"{PROGRAM}.{modname}")
        fn = getattr(m, attr)

        def rec(*a, _fn=fn, _name=attr, **k):
            launches.append((_name, a, k))
            return _fn(*a, **k)

        setattr(m, attr, rec)
        undo.append((m, attr, fn))

    def stop():
        for m, attr, fn in undo:
            setattr(m, attr, fn)

    return stop


def check_sample(traffic: dict, seed: int) -> list:
    """The window's requests that a run checks, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 2]))
    return sorted(rng.choice(traffic["check_span"], traffic["check_requests"],
                             replace=False).tolist())


def readings(config: dict, traffic: dict, seed: int, device, control: bool) -> dict:
    """The numbers compared, on the requests a run of ``seed`` checks,
    without a window: of the program, or (``control``) of the reference
    computed with TF32 matrix products (the precision below the
    configuration's f32) put in the program's place."""
    from ..reference.models import network as ref_network
    from ..reference.points import modules as ref_modules

    if control:
        prog = build_reference(config, seed, device)
        rec_of = lambda: Recorder(prog, ref_network, ref_modules)
    else:
        prog = build_program(config, seed, device)
        rec_of = lambda: record_program(prog)
    stashed = {}
    for idx in check_sample(traffic, seed):
        batch_host = scenes.scene(traffic, seed, 0, idx)
        rec = rec_of()
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control
        try:
            with torch.no_grad():
                out, host, _ = serve(prog, batch_host, device)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
            rec.remove()
        stashed[idx] = stash(out, host, rec)
    del prog, out
    gc.collect()
    ref = build_reference(config, seed, device)
    worst = {}
    for idx, st in stashed.items():
        for k, v in check(ref, st, scenes.scene(traffic, seed, 0, idx), device).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst

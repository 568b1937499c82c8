"""Spans and counters inside the port, on the profiler's clock.

The forward and the renderers open named spans at their layer boundaries
(every name starts with ``gd.``) and add device tensors to two counters:

    gd.forward     ``Network.forward``, the whole body: one request
    gd.encoder     the image encoder call
    gd.voltx       the volume transformer call
    gd.densifier   each ``DensifierStage.forward``
    gd.render      ``rasterize`` / ``rasterize_surfels``, one per view
    gd.project     the projection (3DGS) or the surfel set-up (2DGS)
    gd.bin         the tile binning and the per-tile cap clamp
    gd.composite   the forward compositor: table pack, kernel, image unpack
    gd.sel_bwd     the fused selection's ``selonly`` backward
    pairs          the (Gaussian, tile) pairs handed to the compositor: the
                   sum of the clamped tile counts
    pairs_dropped  the pairs the budgets dropped: the binning overflow plus
                   the per-tile cap's, the tensor a render returns as
                   ``overflow``

(The launches of each kernel are ``splat.kernels.launch_counts``.)

Tracing is off unless a ``torch.profiler`` is recording (the benchmark's
traced window, or the ``tpu.profile_dir`` trace of the train CLI, which then
shows the ``gd.*`` ranges beside the ``aten::`` ops) or ``enable()`` was
called.  Off, a span reads one flag and returns a shared no-op context: no
profiler range, no CUDA event, no allocation.  On, a span opens a
``record_function`` range of its name, stamps its host start just before the
range opens and its end just after it closes with ``time.time_ns()`` (the
clock of the profiler's event timestamps), so that both clocks hold the
range's own work, and, when CUDA is in use, records a CUDA event on the
current stream at each end.
A counter keeps a reference to the tensor it is given: no host sync; a
Python number is added as it is.

Spans and counters are kept per request (a ``gd.forward`` span with all it
encloses), the last ``KEEP`` requests in memory; spans outside a request
open their range and keep nothing.  Counts of Python numbers outside a
request (a backward, which autograd may run on a thread of its own) add to
``summary()["outside"]``.  Nothing is written or synchronised
until ``summary()``::

    from generativedensification_torch.utils import tracing
    tracing.enable()
    out = net(batch, with_fine=True)
    tracing.disable()
    s = tracing.summary()      # one synchronize
    s["spans"]["gd.composite"]["device_ms"] / s["requests"]
    tracing.reset()

``summary()`` gives, over the kept requests, each span name's count, host
ms and device ms (``None`` without CUDA), each with its self time (the span
minus its direct child spans), and each counter's total.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

REQUEST = "gd.forward"
KEEP = 64

_on = False
_requests: collections.deque = collections.deque(maxlen=KEEP)
_outside: collections.Counter = collections.Counter()
_outside_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Request:
    __slots__ = ("root", "spans", "counters", "done")

    def __init__(self, root: int):
        self.root, self.spans, self.counters, self.done = root, [], {}, False


def _event():
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "id", "parent", "request", "t0", "t1", "e0", "e1", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        if up is not None:
            self.request = up.request
        elif self.name == REQUEST:
            self.request = _Request(self.id)
            _requests.append(self.request)
        else:
            self.request = None
        self._rf = record_function(self.name)
        self.t0 = time.time_ns()
        self._rf.__enter__()
        self.e0 = _event() if self.request is not None else None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.request is not None:
            self.e1 = _event()
        self._rf.__exit__(*exc)
        self.t1 = time.time_ns()
        if self.request is not None:
            self.request.spans.append(self)
            if self.parent is None:
                self.request.done = True
        return False


def enable() -> None:
    """Trace every span and counter until ``disable()``."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str):
    """A context manager: the span ``name`` while tracing is on, else a
    shared no-op."""
    if not (_on or _profiler_enabled()):
        return _OFF
    return _Span(name)


def traced(name: str):
    """Decorate a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, value) -> None:
    """Add the sum of ``value`` (a tensor, kept as a reference and summed in
    ``summary()``, or a Python number) to the counter ``name`` of the
    current request; a number counted outside any request adds to the
    ``outside`` counters."""
    if not (_on or _profiler_enabled()):
        return
    number = not isinstance(value, torch.Tensor)
    stack = _stack()
    if stack and stack[-1].request is not None:
        stack[-1].request.counters.setdefault(name, []).append(
            value if number else value.detach())
    elif number:
        with _outside_lock:
            _outside[name] += value


def reset() -> None:
    """Forget every kept request and the outside counters."""
    _requests.clear()
    with _outside_lock:
        _outside.clear()


def records() -> list:
    """The closed spans of the kept, finished requests, as dicts (``t0`` /
    ``t1`` host ns on the profiler's clock, ``request`` the root's id)."""
    return [{"name": s.name, "id": s.id, "parent": s.parent, "request": req.root,
             "t0": s.t0, "t1": s.t1}
            for req in list(_requests) if req.done for s in req.spans]


def summary() -> dict:
    """Totals over the kept, finished requests: ``{"requests": n, "spans":
    {name: {count, host_ms, device_ms, self_host_ms, self_device_ms}},
    "counters": {name: total}, "outside": {name: total}}`` (device ms
    ``None`` without CUDA events; ``outside`` the numbers counted outside
    any request).  Synchronises once."""
    reqs = [r for r in list(_requests) if r.done]
    if any(s.e0 is not None for r in reqs for s in r.spans):
        torch.cuda.synchronize()
    spans, tallies = {}, collections.defaultdict(list)
    for req in reqs:
        times = {}
        for s in req.spans:
            dev = s.e0.elapsed_time(s.e1) if s.e0 is not None else None
            times[s.id] = [(s.t1 - s.t0) * 1e-6, dev, s.name]
        child = collections.defaultdict(lambda: [0.0, 0.0])
        for s in req.spans:
            if s.parent is not None:
                host, dev, _ = times[s.id]
                child[s.parent][0] += host
                child[s.parent][1] += dev or 0.0
        for sid, (host, dev, name) in times.items():
            t = spans.setdefault(name, {"count": 0, "host_ms": 0.0, "device_ms": None,
                                        "self_host_ms": 0.0, "self_device_ms": None})
            t["count"] += 1
            t["host_ms"] += host
            t["self_host_ms"] += host - child[sid][0]
            if dev is not None:
                t["device_ms"] = (t["device_ms"] or 0.0) + dev
                t["self_device_ms"] = (t["self_device_ms"] or 0.0) + dev - child[sid][1]
        for name, vals in req.counters.items():
            tallies[name] += vals
    counters = {}
    for name, vals in tallies.items():
        sums = [v.sum() for v in vals if isinstance(v, torch.Tensor)]
        counters[name] = (sum(v for v in vals if not isinstance(v, torch.Tensor))
                          + (torch.stack(sums).sum().item() if sums else 0))
    with _outside_lock:
        outside = dict(_outside)
    return {"requests": len(reqs), "spans": spans, "counters": counters,
            "outside": outside}

"""Per-request spans from CUDA events, recorded by the benchmark around the
calls into each layer of the program (forward hooks on its modules,
wrappers of module-level functions), as the port's ``chip_smoke.py``
``forward_breakdown`` / ``train_breakdown`` record them.

Each span also opens a ``torch.profiler.record_function`` range of its
name, so that a profiled window can say what the host was doing.  Events
are kept on the stream and read once, after the window has closed.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd.profiler import record_function


class Spans:
    def __init__(self):
        self.requests = []              # one {name: [(start, end), ...]} each
        self.current = collections.defaultdict(list)
        self._undo = []

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _open(self, name):
        rf = record_function(name)
        rf.__enter__()
        self.current[name].append([self._event(), None, rf])

    def _close(self, name):
        span = self.current[name][-1]
        span[1] = self._event()
        span[2].__exit__(None, None, None)

    def module(self, name: str, mod: torch.nn.Module) -> None:
        """Span ``name`` around every forward of ``mod``."""
        h1 = mod.register_forward_pre_hook(lambda m, a: self._open(name))
        h2 = mod.register_forward_hook(lambda m, a, o: self._close(name))
        self._undo += [h1.remove, h2.remove]

    def function(self, name: str, owner, attr: str) -> None:
        """Span ``name`` around every call of ``owner.attr``."""
        fn = getattr(owner, attr)

        def run(*a, **k):
            self._open(name)
            try:
                return fn(*a, **k)
            finally:
                self._close(name)

        setattr(owner, attr, run)
        self._undo.append(lambda: setattr(owner, attr, fn))

    def end_request(self) -> None:
        self.requests.append(dict(self.current))
        self.current = collections.defaultdict(list)

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def mean_ms(self) -> dict:
        """{name: mean over requests of the span's summed device ms}."""
        torch.cuda.synchronize()
        sums = collections.defaultdict(float)
        for req in self.requests:
            for name, spans in req.items():
                sums[name] += sum(s.elapsed_time(e) for s, e, _ in spans)
        n = max(len(self.requests), 1)
        return {k: v / n for k, v in sums.items()}

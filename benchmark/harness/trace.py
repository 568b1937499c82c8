"""The device's side of a traced window, from ``torch.profiler``: busy time,
device time by kernel name, and the longest idle gaps by what the host was
doing, as the port's ``chip_smoke.py::device_busy`` reads it (every device
kernel, copy and set, user annotations left out).

The profiler's trace stays in memory and is freed after reading; nothing
is written to disk.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

TOP = 10


class Trace:
    def __init__(self):
        self.prof = None
        self.window_s = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """busy_s, window_s, device seconds by kernel name, and the
        breakdown's device_ops and idle_gaps."""
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            user = getattr(e, "is_user_annotation", lambda: False)()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not user:
                    dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.prof = None
        by_name = collections.defaultdict(float)
        for s, t, name in dev:
            by_name[name] += (t - s) * 1e-9
        dev.sort()
        busy_ns, gaps = 0, []
        cur_s = cur_t = None
        for s, t, _ in dev:
            if cur_t is None or s > cur_t:
                if cur_t is not None:
                    busy_ns += cur_t - cur_s
                    gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_t is not None:
            busy_ns += cur_t - cur_s
        host.sort()
        starts = [h[0] for h in host]
        gap_by = collections.defaultdict(float)
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            gap_by[_host_at(host, starts, (g0 + g1) // 2)] += (g1 - g0) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        return {
            "busy_s": busy_ns * 1e-9,
            "window_s": self.window_s,
            "by_name": dict(by_name),
            "breakdown": {
                "device_ops": [[n, s] for n, s in ops[:TOP]],
                "idle_gaps": [[n, s] for n, s in
                              sorted(gap_by.items(), key=lambda kv: -kv[1])[:TOP]],
            },
        }


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost host range that covers time ``t``: the latest-starting
    of those that cover it (``host`` sorted by start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 20000, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no host range)"

"""Debug and observability hooks, config-gated.

Port of ``generativedensification_tpu/utils/debugging.py``:

  * ``nan_guard`` — wrap a step function so that its scalar stats are
    checked for NaN / Inf after each call (``tpu.nan_check``);
  * ``maybe_profile`` — a ``torch.profiler`` trace of the enclosed steps
    (CPU and, on a card, CUDA activity) written as a Chrome trace into
    ``tpu.profile_dir``, as the JAX CLI traces its step 20.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import numpy as np


def nan_guard(step_fn: Callable, enabled: bool = True) -> Callable:
    """Wrap (state, batch) -> (state, stats): raise on non-finite stats."""
    if not enabled:
        return step_fn

    def wrapped(state, batch):
        state, stats = step_fn(state, batch)
        bad = {
            k: float(v)
            for k, v in stats.items()
            if np.ndim(v) == 0 and not np.isfinite(float(v))
        }
        if bad:
            raise FloatingPointError(
                f"non-finite training stats (nan_check=True): {bad}"
            )
        return state, stats

    return wrapped


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """Trace the enclosed steps into ``profile_dir/trace.json`` if set."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

"""Timing on the card, its published rates, and the operation counts of the
compositor kernels from which a roofline bound is reckoned.

The bound of a kernel call is the larger of its bytes over the memory rate
(each input read once, each output written once) and its f32 operations
over the f32 rate, the operations counted from the call's own data (the
evaluations and contributions its plain version counts).
"""

from __future__ import annotations

import statistics
import subprocess
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
# operations per (slot, live pixel) evaluation of a compositor: 2 diffs,
# 7 products/sums of the power form, clamp, exp, opacity product, alpha
# clamp, the 1/255 compare
OPS_PER_EVAL = 17
# per contributing pair, forward: 1 - alpha, U, the 1e-4 compare, w, and 4
# multiply-adds into color and depth
OPS_PER_CONTRIB = 12
# per contributing pair, backward: the forward's 4, contrib (7), the prefix
# (2), suffix, max + reciprocal, g_alpha (3), g_power (2), gx and gy (8) =
# 29, then the mode's row sums: |gx|, |gy| (4); full adds the ten signed
# rows (21); noabs has only those
OPS_PER_CONTRIB_BWD = {"full": 54, "noabs": 50, "selonly": 33}
# the surfel kernels (csrc/surfel_fwd.cu, csrc/surfel_bwd.cu): the circle
# test per (slot, live pixel) is 2 differences, 3 products/sums and a
# compare; inside the circle, the three affine cr rows (12), the |cr_z|
# guard (3), the reciprocal, u, v, the object-space power (4), the filter
# power, the max (2), z, exp, the opacity product, the alpha clamp and two
# compares = 31; per contribution, forward: 1 - alpha, U, the 1e-4 compare,
# the median crossing (3), w, six color/normal and one depth multiply-add
# (14), the mapped depth (4), w·m and three moment sums (5) = 30; backward
# selonly: the chain (4), cw (5), prefix (2), the clamped reciprocal (2),
# g_alpha (4), g_power (2), the branch selects (2), rz², d cr (10), the
# filter terms (4), the guard, the two screen rows (14) and their abs sums
# (4) = 55; full: the chain (4), cw with the distortion terms (25), prefix,
# reciprocal, g_alpha, g_power, selects, rz², d cr (19), the filter terms
# (4), dL/dm, dm/dz, the crossing and gz (14), the z term of d cr_z (3),
# the guard, 13 row products and 19 row sums = 106
SURFEL_OPS_PER_EVAL = 6
SURFEL_OPS_PER_INSIDE = 31
SURFEL_OPS_PER_CONTRIB = {"fwd": 30, "selonly": 55, "full": 106}


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, before=None) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events);
    ``before()``, if given, runs ahead of each call outside the timing."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cold_l2(dev, spin_cycles: int = 1_000_000):
    """A ``before`` for ``cuda_ms``: reads a 256 MB buffer, so that the timed
    call finds the 50 MB L2 cache cold, then keeps the card busy as
    ``busy`` does."""
    import torch

    scratch = torch.zeros(64 * 2**20, dtype=torch.float32, device=dev)
    spin = busy(spin_cycles)

    def before():
        scratch.sum()
        spin()

    return before


def busy(spin_cycles: int = 1_000_000):
    """A ``before`` for ``cuda_ms``: keeps the card busy for ``spin_cycles``
    clock cycles (~0.5 ms) while the host enqueues the timed call, so that
    the interval holds the device's work and not the caller's host time (a
    launch that finds the card idle would count the wrapper's Python)."""
    import torch

    return lambda: torch.cuda._sleep(spin_cycles)


def once(fn, on_card: bool):
    """``fn()`` and its device time in ms by CUDA events (None off the
    card)."""
    import torch

    if not on_card:
        return fn(), None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = fn()
    b.record()
    b.synchronize()
    return r, a.elapsed_time(b)


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median host-clock time of ``fn()`` over ``reps`` calls: a CPU time,
    never a device one."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(n_bytes: int, ops: int) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bytes=n_bytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")

"""Kernel #2 (the 3DGS compositor backward, ``composite_bwd_kernel``: its
``selonly`` and ``noabs`` launches) in the train micro-step against its
roofline: the least time its launches need (``harness/counting.py``: the
pairs the inputs need times each mode's per-pair operations, bytes read and
written once, the published f32 and HBM peaks), counted on the last traced
micro-step's launches and scaled to the traced micro-steps, over the device
time the profiler gives the kernel, %."""

from benchmark.harness.roofline import share


def read(r):
    return share(r, ("composite_bwd",), ("composite_bwd_kernel",))

"""Kernels #3 and #4 (the 2DGS surfel compositor forward and backward,
``surfel_fwd_kernel`` / ``surfel_bwd_kernel``) against their roofline:
the least time their launches need (``harness/counting.py``: the pairs the
inputs need, bytes read and written once, the published f32 and HBM peaks)
over the device time the profiler gives them, %.  The bound is counted on
the last traced request's launches and scaled to the traced requests."""

from benchmark.harness.roofline import share

WRAPPERS = ("surfel_fwd", "surfel_bwd")
KERNELS = ("surfel_fwd_kernel", "surfel_bwd_kernel")


def read(r):
    return share(r, WRAPPERS, KERNELS)

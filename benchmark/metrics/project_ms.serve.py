"""Device ms per request in the projection (3DGS ``project_gaussians``) or
the surfel set-up (2DGS), the program's ``gd.project`` span."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.project", "device_ms")

"""Device ms per request in the fused selection's ``selonly`` backward (the
cotangent, kernel #2 or #4 and the slot-to-Gaussian sums), the program's
``gd.sel_bwd`` span."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.sel_bwd", "device_ms")

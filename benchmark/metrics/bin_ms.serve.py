"""Device ms per request in the tile binning and the per-tile cap clamp,
the program's ``gd.bin`` span."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.bin", "device_ms")

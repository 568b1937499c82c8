"""Host ms per request in the renders (``rasterize`` / ``rasterize_surfels``),
the program's ``gd.render`` span: how long the Python takes to enqueue them."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.render", "host_ms")

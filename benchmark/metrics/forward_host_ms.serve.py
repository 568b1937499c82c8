"""Host ms per request in ``Network.forward``, the program's ``gd.forward``
span: how long the Python takes to enqueue one reconstruction."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.forward", "host_ms")

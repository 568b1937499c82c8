"""Device ms per request in ``Network.forward`` outside its child spans (the
encoder, the volume transformer, the densifier stages and the renders): the
lift, the heads, the selection and its gathers, the fine head, the union
and, for 2DGS, the surface depth and normal maps.  The self time of the
program's ``gd.forward`` span."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.forward", "self_device_ms")

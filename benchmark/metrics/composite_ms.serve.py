"""Device ms per request in the forward compositor (the table pack, kernel
#1 or #3 and the image unpack), the program's ``gd.composite`` span."""

from benchmark.metrics._program_spans import span_ms


def read(r):
    return span_ms("gd.composite", "device_ms")

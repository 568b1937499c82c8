"""Device ms per request in the densifier stages (``net.stages``: serialization, blocks,
upscaling, heads and gates), from the
benchmark's CUDA-event spans, mean over the traced run's requests."""


def read(r):
    return r["spans_ms"].get("densifier")

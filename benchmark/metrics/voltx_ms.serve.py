"""Device ms per request in the volume transformer (``net.vol_decoder``, ``models/backbone.py``), from the
benchmark's CUDA-event spans, mean over the traced run's requests."""


def read(r):
    return r["spans_ms"].get("voltx")

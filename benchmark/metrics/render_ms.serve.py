"""Device ms per request in every render call (``rasterize`` or ``rasterize_surfels`` as
``models/network.py`` calls them: projection or surfel set-up, binning,
the compositors and the selection backward), from the
benchmark's CUDA-event spans, mean over the traced run's requests."""


def read(r):
    return r["spans_ms"].get("render")

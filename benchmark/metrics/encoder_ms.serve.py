"""Device ms per request in the image encoder (``net.img_encoder``, ``models/vit.py``), from the
benchmark's CUDA-event spans, mean over the traced run's requests."""


def read(r):
    return r["spans_ms"].get("encoder")

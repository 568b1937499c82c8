"""Device ms per micro-step in ``optimizer.step`` (the accumulation, and on
every second micro-step the clip and the AdamW update), from CUDA events
around that one instance's ``step``, mean over the traced run's
micro-steps."""


def read(r):
    return r.get("spans_ms", {}).get("optim")

"""Host ms per micro-step that the loop waited on the prefetch thread's
queue for its samples (host clock), mean over the traced run's window."""


def read(r):
    return r.get("data_wait_ms")

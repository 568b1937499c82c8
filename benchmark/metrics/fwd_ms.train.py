"""Device ms per micro-step in the network's forward (``net(batch, ...)``:
coarse and fine, the renders and the selection backward in it), from CUDA
events in a forward pre-hook and hook on the network, mean over the traced
run's micro-steps."""


def read(r):
    return r.get("spans_ms", {}).get("fwd")

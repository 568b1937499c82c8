"""Device ms per micro-step outside the forward and the optimizer: the loss,
``loss.backward()`` and the gradient norm.  The micro-step's span (CUDA
events around the step call) less ``fwd_ms.train`` and
``optim_ms.train``."""


def read(r):
    s = r.get("spans_ms", {})
    if not all(k in s for k in ("step", "fwd", "optim")):
        return None
    return s["step"] - s["fwd"] - s["optim"]

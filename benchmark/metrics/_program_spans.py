"""The program's own spans and counters (``utils/tracing.py`` of the port),
recorded while the traced window's profiler ran: per-request means over the
requests it kept.  ``None`` where the program has no such module (an older
commit) or recorded no request."""

import importlib

TRACING = "generativedensification_torch.utils.tracing"


def _summary():
    try:
        tracing = importlib.import_module(TRACING)
    except ImportError:
        return None
    s = tracing.summary()
    return s if s["requests"] else None


def span_ms(name: str, field: str):
    """``field`` (``device_ms``, ``host_ms``, ``self_device_ms``, ...) of the
    span ``name``, per request."""
    s = _summary()
    v = None if s is None else s["spans"].get(name, {}).get(field)
    return None if v is None else v / s["requests"]


def counter(name: str):
    """The counter ``name`` per request."""
    s = _summary()
    v = None if s is None else s["counters"].get(name)
    return None if v is None else v / s["requests"]

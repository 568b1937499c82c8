"""A kernel family's share of its roofline in a traced run."""

from __future__ import annotations

from .counting import bound_s


def share(r: dict, wrappers: tuple, kernels: tuple):
    """100 × (the least time of the family's launches in one traced request,
    scaled to the traced requests) / (the device time of the kernels whose
    names hold one of ``kernels``); None where the run launched none."""
    t = r.get("trace")
    costs = [c for c in r.get("launch_costs", ()) if c[0] in wrappers]
    if not t or not costs or not r.get("traced_requests"):
        return None
    dev_s = sum(s for name, s in t["by_name"].items() if any(k in name for k in kernels))
    if dev_s <= 0:
        return None
    least = sum(bound_s(b, ops) for _, b, ops in costs) * r["traced_requests"]
    return 100.0 * least / dev_s

"""The 95th percentile of every request's latency in the window, from the
hand-over of its host tensors to its outputs on the host (host clock), ms."""

from benchmark.harness.spec import latency_quantile


def read(r):
    return latency_quantile(r["latencies_s"], 0.95) * 1e3

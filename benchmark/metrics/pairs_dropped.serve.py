"""Pairs per request dropped by the budgets (binning overflow plus the
per-tile cap): the program's ``pairs_dropped`` counter, the sum of the
renders' ``overflow``."""

from benchmark.metrics._program_spans import counter


def read(r):
    return counter("pairs_dropped")

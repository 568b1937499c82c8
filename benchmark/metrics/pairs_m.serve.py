"""Millions of (Gaussian, tile) pairs per request handed to the forward
compositors: the sum of the clamped tile counts, the program's ``pairs``
counter."""

from benchmark.metrics._program_spans import counter


def read(r):
    v = counter("pairs")
    return None if v is None else v * 1e-6

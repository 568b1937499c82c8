"""Reconstructions completed in the window over the window's length (host
clock): every request served without failing, over all the window's time."""


def read(r):
    return (r["attempted"] - r["failed"]) / r["window_s"]

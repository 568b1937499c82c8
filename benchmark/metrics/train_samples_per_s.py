"""Training samples completed in the window over the window's length (host
clock): the samples of every micro-step whose loss and gradient norm came
out finite, over all the window's time (the window ends at an
accumulation boundary, after one synchronize)."""


def read(r):
    return (r["attempted"] - r["failed"]) * r["samples_per_step"] / r["window_s"]

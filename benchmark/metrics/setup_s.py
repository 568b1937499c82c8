"""Seconds from the process's start to the first timed request: loading,
building the kernels (the first run in a checkout), making the weights and
warming up (host clock)."""


def read(r):
    return r["setup_s"]

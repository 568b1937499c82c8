"""The device memory the program held at its peak in the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
GiB."""


def read(r):
    return r["memory_peak_bytes"] / float(1 << 30) if r["memory_peak_bytes"] else None

"""The port's ``BatchLoader`` prefetch must overlap dataset IO with the
training step.

Counterpart of ``tests/test_loader_overlap.py`` for
``generativedensification_torch.data.pipeline.BatchLoader``, with the same
dataset, sleeps, arguments and bound: the dataset does a real HDF5 read
plus a fixed sleep (sleeps overlap without a free core, so the bound holds
under CPU contention), the consumer's "step" sleeps too; with the prefetch
thread working, the wall time approaches max(io, step) per batch instead of
their sum."""

import os
import time

import h5py
import numpy as np

from generativedensification_torch.data.pipeline import BatchLoader


class _H5SleepDataset:
    def __init__(self, path, n, io_sleep):
        self.path = path
        self.n = n
        self.io_sleep = io_sleep

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with h5py.File(self.path, "r") as f:
            img = f["images"][i][()]
        time.sleep(self.io_sleep)
        return {"images": img, "meta": {"i": i}}


def test_prefetch_overlaps_io_with_step(tmp_path):
    path = os.path.join(tmp_path, "scenes.h5")
    n, hw = 8, 64
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "images", data=np.random.default_rng(0).random((n, hw, hw, 3)),
            dtype=np.float32,
        )

    io_s, step_s = 0.10, 0.10
    ds = _H5SleepDataset(path, n, io_s)
    loader = BatchLoader(
        ds, batch_size=1, shuffle=False, num_prefetch=2,
        process_index=0, process_count=1,
    )

    t0 = time.perf_counter()
    nb = 0
    for batch in loader:
        assert batch["images"].shape == (1, hw, hw, 3)
        assert batch["meta"] == [{"i": nb}]
        time.sleep(step_s)   # the "train step"
        nb += 1
    wall = time.perf_counter() - t0

    assert nb == n
    serial = n * (io_s + step_s)            # no overlap: ~1.6 s
    overlapped = n * max(io_s, step_s)      # perfect overlap: ~0.8 s
    # at least half of the ideal overlap's gain; the HDF5 read itself (~ms)
    # and the thread's wake-ups eat a little of it
    assert wall < serial - 0.5 * (serial - overlapped), (
        f"prefetch did not overlap: wall={wall:.2f}s serial={serial:.2f}s "
        f"ideal={overlapped:.2f}s"
    )

"""Batching and the host-to-device feed.

Port of ``generativedensification_tpu/data/pipeline.py``: ``BatchLoader``
shuffles by ``seed + epoch``, shards the scenes round robin per process
(the ``DistributedSampler`` scheme; the rank and world size come from
``torch.distributed`` when it is initialised), cuts each epoch to
``epoch_fraction``, builds batches in a prefetch thread and re-raises a
worker's exception in the consumer; ``collate`` stacks samples and
``to_device_batch`` moves a batch to a device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..utils.device import resolve_device


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into a batch dict (metas listed)."""
    out = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = [s["meta"] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


def process_rank() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when initialised, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BatchLoader:
    """Shuffling, sharding, prefetching batch iterator."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_prefetch: int = 2,
        process_index: int | None = None,
        process_count: int | None = None,
        epoch_fraction: float = 1.0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_prefetch = num_prefetch
        if process_index is None:
            process_index, process_count = process_rank()
        self.process_index = process_index
        self.process_count = process_count or 1
        self.epoch_fraction = epoch_fraction
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.process_count
        n = int(n * self.epoch_fraction)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        # per-process shard (round robin, the DistributedSampler scheme)
        idx = idx[self.process_index:: self.process_count]
        idx = idx[: int(len(idx) * self.epoch_fraction)]
        return idx

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        stop = object()
        err: list[BaseException] = []

        def worker():
            try:
                for b in range(nb):
                    sel = idx[b * self.batch_size: (b + 1) * self.batch_size]
                    if len(sel) < self.batch_size and self.drop_last:
                        break
                    q.put(collate([self.dataset[int(i)] for i in sel]))
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise RuntimeError(
                        "BatchLoader worker failed while building a batch"
                    ) from err[0]
                break
            yield item
        self.epoch += 1


def to_device_batch(batch: dict, device=None, keep_meta: bool = False) -> dict:
    """Collated numpy batch -> tensors on ``device`` (``None``: the card);
    the meta entry is dropped unless asked for."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        if k != "meta":
            out[k] = torch.as_tensor(np.ascontiguousarray(v), device=dev)
        elif keep_meta:
            out[k] = v
    return out

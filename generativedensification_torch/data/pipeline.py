"""Batching and the host-to-device feed (port of the parts of
``generativedensification_tpu/data/pipeline.py`` that evaluation uses; the
sharding, prefetching ``BatchLoader`` arrives with ROADMAP queue 1, data
and the train CLI)."""

from __future__ import annotations

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

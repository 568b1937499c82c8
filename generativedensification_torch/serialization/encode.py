"""Order dispatch (port of ``generativedensification_tpu/serialization/
encode.py`` for the decoder's path: codes without a packed batch index,
since the point sets are batched densely and sorted per sample)."""

from __future__ import annotations

import torch

from .hilbert import hilbert_encode
from .zorder import z_encode

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def encode(grid_coord: torch.Tensor, depth: int = 16, order: str = "z") -> torch.Tensor:
    """(..., 3) grid coords -> (...,) int64 keys ``hi * 2**24 + lo``."""
    if order not in ORDERS:
        raise NotImplementedError(f"unknown order {order!r}; use one of {ORDERS}")
    if depth > 16:
        raise ValueError(f"depth must be <= 16, got {depth}")
    gc = grid_coord
    if order.endswith("-trans"):
        # column views, not a list index: that copies an index tensor from
        # the host and waits for the stream
        gc = torch.stack([gc[..., 1], gc[..., 0], gc[..., 2]], dim=-1)
    if order.startswith("z"):
        return z_encode(gc, depth=depth)
    return hilbert_encode(gc, num_bits=depth)

"""Hilbert-curve codes via Skilling's transpose algorithm, as int64 keys.

Port of ``generativedensification_tpu/serialization/hilbert.py``: the same
branch-free construction on packed coordinates (values below 2**16 in int64
tensors), packed into the key of :mod:`.zorder`.
"""

from __future__ import annotations

import torch

from .zorder import interleave3


def _axes_to_transpose(x, y, z, num_bits: int):
    """Skilling AxesToTranspose: Hilbert transpose-form coordinates."""
    X = [x, y, z]
    zero = torch.zeros_like(x)

    # inverse-undo excess work
    Q = 1 << (num_bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            has = (X[i] & Q) != 0
            t = torch.where(has, zero, (X[0] ^ X[i]) & P)
            x0_new = torch.where(has, X[0] ^ P, X[0] ^ t)
            if i != 0:
                X[i] = X[i] ^ t
            X[0] = x0_new
        Q >>= 1

    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = zero
    Q = 1 << (num_bits - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return [xi ^ t for xi in X]


def hilbert_encode(grid_coord: torch.Tensor, num_bits: int = 16) -> torch.Tensor:
    """(..., 3) grid coords -> (...,) int64 Hilbert keys."""
    mask = (1 << num_bits) - 1
    gc = grid_coord.long() & 0xFFFFFFFF & mask
    X = _axes_to_transpose(gc[..., 0], gc[..., 1], gc[..., 2], num_bits)
    # transpose form: bit b of X[0] -> code bit 3b+2, X[1] -> 3b+1, X[2] -> 3b
    return interleave3(X[0], X[1], X[2])

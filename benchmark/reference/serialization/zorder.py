"""Morton (z-order) codes via magic-number bit spreading, as int64 keys.

Port of ``generativedensification_tpu/serialization/zorder.py``.  Bit ``i``
of x maps to code bit ``3i+2``, y to ``3i+1``, z to ``3i``.  The JAX package
keeps a code as a ``[hi, lo]`` uint32 pair (``lo`` the interleaved low 8
bits of each axis, ``hi`` bits 8..15, 24 bits each) and sorts it
lexicographically; here the same code is the one int64 key
``hi * 2**24 + lo``, which orders identically.  Every operation is on
non-negative int64 values below 2**32 (torch's uint32 bit operations are
incomplete), so the bits equal the uint32 ones.
"""

from __future__ import annotations

import torch

LO_BITS = 24  # 3 * 8 interleaved bits per word

_M0 = 0x3FF
_M16 = 0xFF0000FF
_M8 = 0x0300F00F
_M4 = 0x030C30C3
_M2 = 0x09249249


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so bit i lands at position 3i."""
    v = v & _M0
    v = (v | (v << 16)) & _M16
    v = (v | (v << 8)) & _M8
    v = (v | (v << 4)) & _M4
    v = (v | (v << 2)) & _M2
    return v


def _word(x, y, z):
    return (_part1by2(x & 0xFF) << 2) | (_part1by2(y & 0xFF) << 1) | _part1by2(z & 0xFF)


def interleave3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave 16-bit axes (int64 tensors) into the int64 key
    ``hi * 2**24 + lo``."""
    lo = _word(x, y, z)
    hi = _word(x >> 8, y >> 8, z >> 8)
    return (hi << LO_BITS) | lo


def z_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """(..., 3) non-negative grid coords -> (...,) int64 Morton keys."""
    mask = (1 << depth) - 1
    gc = grid_coord.long() & 0xFFFFFFFF & mask
    return interleave3(gc[..., 0], gc[..., 1], gc[..., 2])

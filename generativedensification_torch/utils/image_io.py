"""8-bit PNG files with zlib alone (no image library: the card host has
neither imageio nor ffmpeg).

``write_png`` stores an (H, W, 3) RGB or (H, W) gray uint8 array as one
IDAT chunk with filter type 0 on every row; ``read_png`` decodes what
``write_png`` writes (and nothing else).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}          # channels -> PNG color type (gray, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(img) -> np.ndarray:
    """[0, 1] floats -> uint8, as the JAX evaluation encodes its images
    (clip, scale by 255, truncate)."""
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W) uint8 array as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1 or 3 channels, got {C}")
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Decode a PNG that ``write_png`` wrote: (H, W, 3) or (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    W, H, depth, color, _, _, interlace = header
    C = {v: k for k, v in _COLOR_TYPE.items()}[color]
    if depth != 8 or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + W * C)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter type 0")
    img = rows[:, 1:].reshape(H, W, C)
    return img[..., 0] if C == 1 else img

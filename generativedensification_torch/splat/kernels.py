"""The 3DGS forward compositor: CUDA kernel wrapper, launch count and the
plain PyTorch version.

Replaces ``generativedensification_tpu/splat/pallas_kernels.py``'s
``pallas_composite_fwd``.  The kernel (``csrc/composite_fwd.cu``) is built
with ``nvcc`` for ``sm_90a`` into a plain-C shared library at first use and
loaded with ``ctypes``; nothing is compiled or imported for it when this
module is imported.

``composite_fwd`` is the one entry: tensors on the card launch the kernel
(or raise), tensors on the CPU take ``composite_fwd_plain``.  Nothing else
chooses.

Inputs (shared by both versions):
  table       (N, 12) f32 per-gaussian rows
              [x, y, a, b, c, opacity, r, g, b, depth, valid, 0]
  sorted_ids  (P,) i32 gaussian of each depth-sorted slot
  tile_starts (T,) i32 first slot of each tile's segment
  tile_counts (T,) i32 slots per tile, already clamped to the per-tile cap
              (start + count <= P and every id < N, as binning gives them)
Output: (T, 5, ts*ts) f32 rows [r, g, b, depth, alpha = 1 - T_final].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
TABLE_W = 12
OUT_ROWS = 5
CHUNK = 32    # slots per gathered block of the plain version

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "composite_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches of each kernel of this module; a wrapper adds one where it
# launches, and nowhere else
launch_counts = {"composite_fwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class _Library:
    """The built shared library and what its build reported."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = 0.0
        self.build_log = ""


_library = _Library()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> _Library:
    """Compile ``csrc/composite_fwd.cu`` (once per source and flag set) into
    ``build/`` and load it.  Returns the library record with the build time
    and nvcc's ``-Xptxas -v`` report (registers, shared memory, spills)."""
    if _library.lib is not None:
        return _library
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"composite_fwd_{tag}.so"
    t0 = time.perf_counter()
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
        _library.build_log = res.stdout + res.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.gd_composite_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _library.build_seconds = time.perf_counter() - t0
    _library.path = so
    _library.lib = lib
    return _library


def _check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != TABLE_W:
        raise ValueError(f"table must be (N, {TABLE_W}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("sorted_ids", sorted_ids), ("tile_starts", tile_starts),
                    ("tile_counts", tile_counts)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tile_starts.shape[0] != num_tiles or tile_counts.shape[0] != num_tiles:
        raise ValueError("tile_starts / tile_counts must have one entry per tile")


def composite_fwd(table, sorted_ids, tile_starts, tile_counts,
                  tiles_x: int, tiles_y: int, tile_size: int) -> torch.Tensor:
    """Composite every tile; (T, 5, ts²) rows [r, g, b, depth, alpha]."""
    num_tiles = tiles_x * tiles_y
    _check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles)
    dev = table.device
    if dev.type == "cpu":
        return composite_fwd_plain(table, sorted_ids, tile_starts, tile_counts,
                                   tiles_x, tiles_y, tile_size)
    if dev.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {dev}")
    if tile_size not in (16, 32):
        raise ValueError(f"the CUDA compositor takes 16 or 32 px tiles, "
                         f"got {tile_size}")
    for t in (sorted_ids, tile_starts, tile_counts):
        if t.device != dev:
            raise ValueError("all compositor inputs must be on one device")
    if not all(t.is_contiguous() for t in (table, sorted_ids, tile_starts,
                                           tile_counts)):
        raise ValueError("compositor inputs must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    lib = build().lib
    out = torch.empty((num_tiles, OUT_ROWS, tile_size * tile_size),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gd_composite_fwd(
            table.data_ptr(), sorted_ids.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), out.data_ptr(), num_tiles, tiles_x,
            tile_size, stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    launch_counts["composite_fwd"] += 1
    return out


def composite_fwd_plain(table, sorted_ids, tile_starts, tile_counts,
                        tiles_x: int, tiles_y: int, tile_size: int,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the semantics of the JAX
    ``_xla_fwd``: chunks of CHUNK slots of every tile are gathered and
    their alpha computed as one (T, CHUNK, ts²) block; the transmittance
    chain then steps through the chunk slot by slot, in the kernel's order
    and rounding, so this version is the kernel's bit-level reference.

    ``stats``, if given, receives the number of (slot, live pixel)
    evaluations and of contributing pairs (the kernel's data-dependent
    work, for its roofline bound)."""
    dev = table.device
    ts = tile_size
    npix = ts * ts
    num_tiles = tiles_x * tiles_y
    f32 = torch.float32
    p = torch.arange(npix, device=dev)
    px = (p % ts).to(f32)
    py = torch.div(p, ts, rounding_mode="floor").to(f32)
    t = torch.arange(num_tiles, device=dev)
    ox = ((t % tiles_x) * ts).to(f32)[:, None]
    oy = (torch.div(t, tiles_x, rounding_mode="floor") * ts).to(f32)[:, None]

    T = torch.ones((num_tiles, npix), dtype=f32, device=dev)
    acc = torch.zeros((4, num_tiles, npix), dtype=f32, device=dev)  # r g b z
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_contrib = torch.zeros((), dtype=torch.int64, device=dev)

    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    P = sorted_ids.shape[0]
    k = torch.arange(CHUNK, device=dev)[None, :]
    for c0 in range(0, max_count, CHUNK):
        in_range = (c0 + k) < counts                            # (T, K)
        slot = torch.clamp(starts + c0 + k, max=max(P - 1, 0))
        rows = table[sorted_ids[slot].long()]                   # (T, K, 12)
        gx = (rows[..., 0] - ox)[..., None]
        gy = (rows[..., 1] - oy)[..., None]
        a, b, c = (rows[..., i][..., None] for i in (2, 3, 4))
        opa = torch.where(in_range & (rows[..., 10] > 0), rows[..., 5],
                          torch.zeros_like(rows[..., 5]))[..., None]
        dx = px - gx                                            # (T, K, npix)
        dy = py - gy
        power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy,
                            max=0.0)
        alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
        hit = (alpha >= ALPHA_MIN) & in_range[..., None]
        cols = rows[..., 6:10].permute(1, 2, 0)                 # (K, 4, T)
        for j in range(min(CHUNK, max_count - c0)):
            a_j = alpha[:, j]
            if stats is not None:
                n_eval += (alive & in_range[:, j:j + 1]).sum()
            use = alive & hit[:, j]
            U = T * (1.0 - a_j)
            stop = use & (U < T_EPS)
            alive = alive & ~stop
            take = use & ~stop
            w = a_j * T
            acc = torch.where(take, acc + w * cols[j][..., None], acc)
            T = torch.where(take, U, T)
            if stats is not None:
                n_contrib += take.sum()
    if stats is not None:
        stats["evals"] = int(n_eval)
        stats["contribs"] = int(n_contrib)
    return torch.cat([acc.permute(1, 0, 2), (1.0 - T)[:, None]], dim=1)

"""The 3DGS compositing kernels and the slot-reduction kernels: CUDA kernel
wrappers, launch counts and the plain PyTorch versions; the build of every
kernel of the port.

Replaces ``generativedensification_tpu/splat/pallas_kernels.py``'s
``pallas_composite_fwd`` (``csrc/composite_fwd.cu``),
``pallas_composite_bwd`` (``csrc/composite_bwd.cu``), ``pallas_reduce_slots``
(``csrc/reduce_slots.cu``) and ``pallas_transpose16``
(``csrc/transpose_rows.cu``).  The 2DGS surfel kernels
(``csrc/surfel_fwd.cu``, ``csrc/surfel_bwd.cu``) have their wrappers in
``surfel_kernels.py`` and the stage probes of the two forwards
(``csrc/composite_fwd_probe.cu``, ``csrc/surfel_fwd_probe.cu``) in
``probe_kernels.py``, and the renders' pre-pass (``csrc/prepass.cu``: the
projection and its backward, the surfel set-up and the tile binning, which
replace no TPU kernel) in ``projection.py``, ``surfel.py`` and ``binning.py``; all are
registered here, so that
``build()`` compiles every source and ``launch_counts`` counts every
launch.  Each source is
built with ``nvcc`` for ``sm_90a`` into a plain-C shared library at first
use (the sources asked for compiled at once, one ``nvcc`` each) and loaded
with ``ctypes``; nothing is compiled or imported for them when this module
is imported.

``composite_fwd``, ``composite_bwd``, ``reduce_slots`` and ``transpose_rows``
are the entries: tensors on the card launch the kernel (or raise), tensors on
the CPU take the plain version.  Nothing else chooses.

Inputs shared by both kernels:
  table       (N, 12) f32 per-gaussian rows
              [x, y, a, b, c, opacity, r, g, b, depth, valid, 0]
  sorted_ids  (P,) i32 gaussian of each depth-sorted slot
  tile_starts (T,) i32 first slot of each tile's segment
  tile_counts (T,) i32 slots per tile, already clamped to the per-tile cap
              (start + count <= P and every id < N, as binning gives them)
Forward output: (T, 5, ts*ts) f32 rows [r, g, b, depth, alpha = 1 - T_final].
The CUDA kernels composite each tile as 16 x 16 sub-tiles and skip the slots
that provably cannot reach one; ``subtile_touch`` is that predicate in
PyTorch, and the plain versions take its result as ``touch=`` (dropped
pairs culled, which changes no bit).
Backward inputs: gc4 (T, 4, ts*ts) f32 rows [gC_r, gC_g, gC_b, gD] (the
tiled image and depth cotangents) and g2 (T, ts*ts) f32, the per-pixel
total G = gC . C + gD . D plus the dL/dT_final term.  Backward output:
(P, BWD_ROWS[mode]) f32, one row per slot (see ``composite_bwd``).
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
CHUNK = 32    # slots per gathered block of the plain versions
# the CUDA compositors' sub-tiles (csrc/composite_subtile.cuh): one CTA per
# SUBTILE x SUBTILE pixels, and the margins of their footprint skip
SUBTILE = 16
SKIP_MARGIN_ABS = 2.0 ** -13
SKIP_MARGIN_REL = 2.0 ** -14
# per-slot rows of each backward mode (the order of ``_xla_bwd``'s columns):
#   full     dx, dy, d conic (3), d opacity, d color (3), d depth, |dx|, |dy|
#   noabs    the first ten
#   selonly  |dx|, |dy|  (the AbsGS selection pass)
BWD_ROWS = {"full": 12, "noabs": 10, "selonly": 2}
_BWD_MODE_ID = {"full": 0, "noabs": 1, "selonly": 2}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches of each kernel of the port; a wrapper adds one where it
# launches, and nowhere else
launch_counts = {"composite_fwd": 0, "composite_bwd": 0, "surfel_fwd": 0,
                 "surfel_bwd": 0, "reduce_slots": 0, "transpose_rows": 0,
                 "composite_fwd_probe": 0, "surfel_fwd_probe": 0, "project": 0,
                 "surfel_setup": 0, "depth_rank": 0, "tile_keys": 0,
                 "tile_ranges": 0, "project_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class _Library:
    """One kernel source, its built shared library and what its build
    reported.  ``argtypes`` are those of the entry point ``gd_<name>``, or a
    dict {kernel: argument types} of the entry points ``gd_<kernel>`` of a
    source that holds several kernels."""

    def __init__(self, name: str, argtypes):
        self.name = name
        self.src = _CSRC / f"{name}.cu"
        self.entries = argtypes if isinstance(argtypes, dict) else {name: argtypes}
        self.argtypes = self.entries.get(name)
        self.lib = None
        self.path = None
        self.build_seconds = 0.0
        self.build_log = ""


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_libraries = {
    "composite_fwd": _Library("composite_fwd", [_P] * 5 + [_I] * 3 + [_P]),
    "composite_bwd": _Library("composite_bwd", [_P] * 7 + [_I] * 4 + [_P]),
    "surfel_fwd": _Library("surfel_fwd", [_P] * 6 + [_I] * 3 + [_P]),
    "surfel_bwd": _Library("surfel_bwd", [_P] * 8 + [_I] * 4 + [_P]),
    "reduce_slots": _Library("reduce_slots", [_P] * 2 + [_I] * 3 + [_P]),
    "transpose_rows": _Library("transpose_rows", [_P] * 2 + [_I] * 2 + [_P]),
    "composite_fwd_probe": _Library("composite_fwd_probe",
                                    [_I] + [_P] * 5 + [_I] * 3 + [_P]),
    "surfel_fwd_probe": _Library("surfel_fwd_probe",
                                 [_I] + [_P] * 6 + [_I] * 3 + [_P]),
    "prepass": _Library("prepass", {
        "project": [_P, _P, _I] + [_P] * 5 + [_I] * 2 + [_P] + [_I] * 2 + [_P, _I]
                   + [_P] * 2 + [_I] * 4 + [_P] * 8,
        "project_bwd": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _P, _I, _I] + [_P] * 11
                       + [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P] + [_I] * 4 + [_P],
        "surfel_setup": [_P, _P, _I] + [_P] * 3 + [_I, _P, _I, _I, _P, _I, _P, _P]
                        + [_I] * 4 + [_F] + [_P] * 13,
        "depth_rank": [_P] * 3 + [_I] + [_P] * 2,
        "tile_keys": [_P] * 9 + [_I] * 7 + [_P],
        "tile_ranges": [_P] * 12 + [_I] * 5 + [_P],
    }),
}
# the sources that serving and training run; the probes build only when a
# breakdown asks for them
MAIN_KERNELS = ("composite_fwd", "composite_bwd", "surfel_fwd", "surfel_bwd",
                "reduce_slots", "transpose_rows", "prepass")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names=None) -> dict[str, _Library]:
    """Compile the sources of ``csrc/`` that ``names`` lists (every one by
    default; once per content and flag set) into ``build/``, all ``nvcc``
    processes started together, and load them.  Returns the library records
    by kernel name, each with its build time and nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills)."""
    todo = [lib for name, lib in _libraries.items()
            if lib.lib is None and (names is None or name in names)]
    if not todo:
        return _libraries
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the shared kernel bodies are part of every source that includes them
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    t0 = time.perf_counter()
    procs = []
    try:
        for lib in todo:
            src = lib.src.read_bytes() + headers
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            lib.path = _BUILD_DIR / f"{lib.name}_{tag}.so"
            if not lib.path.exists():
                tmp = lib.path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                procs.append((lib, proc, tmp))
        for lib, proc, tmp in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {lib.src.name}:\n{out}\n{err}")
            os.replace(tmp, lib.path)
            lib.build_log = out + err
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for lib in todo:
        cdll = ctypes.CDLL(str(lib.path))
        for entry, argtypes in lib.entries.items():
            fn = getattr(cdll, f"gd_{entry}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.build_seconds = time.perf_counter() - t0
        lib.lib = cdll
    return _libraries


def _check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles,
                  width: int = TABLE_W):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != width:
        raise ValueError(f"table must be (N, {width}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("sorted_ids", sorted_ids), ("tile_starts", tile_starts),
                    ("tile_counts", tile_counts)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tile_starts.shape[0] != num_tiles or tile_counts.shape[0] != num_tiles:
        raise ValueError("tile_starts / tile_counts must have one entry per tile")


def _check_cuda(tile_size, table, *rest):
    """What the CUDA kernels take beyond ``_check_inputs``."""
    if tile_size not in (16, 32):
        raise ValueError(f"the CUDA compositors take 16 or 32 px tiles, "
                         f"got {tile_size}")
    if any(t.device != table.device for t in rest):
        raise ValueError("all compositor inputs must be on one device")
    if not all(t.is_contiguous() for t in (table, *rest)):
        raise ValueError("compositor inputs must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")


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
    _check_cuda(tile_size, table, sorted_ids, tile_starts, tile_counts)
    lib = build(MAIN_KERNELS)["composite_fwd"].lib
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
                        stats: dict | None = None,
                        touch: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the semantics of the JAX
    ``_xla_fwd``: chunks of CHUNK slots of every tile are gathered and
    their alpha computed as one (T, CHUNK, ts²) block; the transmittance
    chain then steps through the chunk slot by slot, in the kernel's order
    and rounding, so this version is the kernel's bit-level reference.

    ``touch``, if given (``subtile_touch``'s (sub-tiles, P) mask), culls the
    (slot, sub-tile) pairs it drops, as the kernel's footprint skip does; the
    output is the same.  ``stats``, if given, receives the number of (slot,
    live pixel) evaluations, of those the skip leaves (``evals_kept``, with
    ``touch``) and of contributing pairs (the kernel's data-dependent work,
    for its roofline bound)."""
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
    n_kept = torch.zeros((), dtype=torch.int64, device=dev)
    n_contrib = torch.zeros((), dtype=torch.int64, device=dev)
    q_of_pixel = None if touch is None else _subtile_of_pixel(ts, dev)

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
        kept = None if touch is None else _touch_mask(touch, slot, q_of_pixel)
        if kept is not None:
            hit = hit & kept
        cols = rows[..., 6:10].permute(1, 2, 0)                 # (K, 4, T)
        for j in range(min(CHUNK, max_count - c0)):
            a_j = alpha[:, j]
            if stats is not None:
                live = alive & in_range[:, j:j + 1]
                n_eval += live.sum()
                if kept is not None:
                    n_kept += (live & kept[:, j]).sum()
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
        if touch is not None:
            stats["evals_kept"] = int(n_kept)
        stats["contribs"] = int(n_contrib)
    return torch.cat([acc.permute(1, 0, 2), (1.0 - T)[:, None]], dim=1)


def _subtile_of_pixel(tile_size: int, dev) -> torch.Tensor:
    """(ts²,) the sub-tile q = qy * (ts / 16) + qx of each tile pixel."""
    side = tile_size // SUBTILE
    p = torch.arange(tile_size * tile_size, device=dev)
    x, y = p % tile_size, torch.div(p, tile_size, rounding_mode="floor")
    return (torch.div(y, SUBTILE, rounding_mode="floor") * side
            + torch.div(x, SUBTILE, rounding_mode="floor"))


def _segment_slots(tile_starts, tile_counts):
    """The slots of every tile's segment and the tile of each, (S,) each."""
    counts = tile_counts.long()
    dev = counts.device
    tile = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    rank = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(counts, 0)
                                                      - counts)[tile]
    return tile, tile_starts.long()[tile] + rank


def _touch_mask(touch, slot, q_of_pixel) -> torch.Tensor:
    """(T, K, ts²): whether the skip keeps slot[t, k] for each pixel's
    sub-tile."""
    return touch[:, slot].permute(1, 2, 0)[..., q_of_pixel]


def subtile_keep(gx, gy, a, b, c, opa, rcx, rcy) -> torch.Tensor:
    """The footprint skip's predicate, elementwise (f32 tensors that
    broadcast): can a slot with tile-local centre (gx, gy), conic (a, b, c)
    and folded opacity ``opa`` reach alpha >= 1/255 at a pixel centre of the
    16 x 16 rectangle centred at (rcx, rcy)?  The PyTorch mirror of
    ``csrc/composite_subtile.cuh::subtile_keep``, operation for operation in
    f32 (``torch.log`` may differ from the card's ``logf`` in the last ulp):
    the binning's bound on the rectangle, q >= lambda_min |v|² / 2 and, where
    the eigenvalue gap is >= lambda_max / 16, q >= lambda_max (v·u)² / 2,
    against tau = log(255 opa) plus SKIP_MARGIN_ABS and SKIP_MARGIN_REL ×
    (a + c + 2|b|) × the squared distance to the rectangle's farthest pixel.
    Keeps every slot with a non-finite entry; of the others, drops every
    slot whose opacity is <= 0 and keeps every slot whose conic is not
    positive definite."""
    f32 = torch.float32
    dev = gx.device
    zero = torch.zeros((), dtype=f32, device=dev)
    tiny = torch.tensor(1e-20, dtype=f32, device=dev)
    half = 0.5 * (SUBTILE - 1)
    pos = lambda x: torch.where(x > 0, x, zero)
    finite = (torch.isfinite(gx) & torch.isfinite(gy) & torch.isfinite(a)
              & torch.isfinite(b) & torch.isfinite(c) & torch.isfinite(opa))
    det = a * c - b * b
    pd = (a > 0) & (c > 0) & (det > 0)
    m = 0.5 * (a + c)
    h = 0.5 * (a - c)
    r = torch.sqrt(h * h + b * b)
    lmin = pos(m - r)
    lmax = m + r
    tau = torch.log(opa * 255.0)
    cx = gx - rcx
    cy = gy - rcy
    ax, ay = cx.abs(), cy.abs()
    dxr = pos(ax - half)
    dyr = pos(ay - half)
    bound = (0.5 * lmin) * (dxr * dxr + dyr * dyr)
    v1x, v1y = b, lmax - a
    v2x, v2y = lmax - c, b
    n1 = v1x * v1x + v1y * v1y
    n2 = v2x * v2x + v2y * v2y
    use1 = n1 >= n2
    un = torch.sqrt(torch.where(use1, n1, n2))
    directional = (r * 32.0 >= lmax) & (un >= tiny)
    ux = torch.where(use1, v1x, v2x) / un
    uy = torch.where(use1, v1y, v2y) / un
    du = pos((cx * ux + cy * uy).abs() - half * (ux.abs() + uy.abs()))
    dirb = (0.5 * lmax) * (du * du)
    bound = torch.where(directional, torch.where(bound > dirb, bound, dirb), bound)
    fx, fy = ax + half, ay + half
    scale = ((a + c) + 2.0 * b.abs()) * (fx * fx + fy * fy)
    limit = tau + (SKIP_MARGIN_ABS + SKIP_MARGIN_REL * scale)
    keep = ~(bound > limit)
    keep = torch.where(pd, keep, True)
    keep = torch.where(opa <= 0, False, keep)
    return torch.where(finite, keep, True)


def subtile_touch(table, sorted_ids, tile_starts, tile_counts, tiles_x: int,
                  tiles_y: int, tile_size: int) -> torch.Tensor:
    """The footprint skip of the CUDA compositors for every (sub-tile,
    slot): a (ts² / 256, P) bool tensor, row q = qy * (ts / 16) + qx the
    tile's 16 x 16 sub-tile, True where the kernels keep the slot for that
    sub-tile of its tile (``subtile_keep``), False for slots in no tile's
    segment.  Measurement and tests only: the kernels decide on the card."""
    num_tiles = tiles_x * tiles_y
    _check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles)
    dev = table.device
    side = tile_size // SUBTILE
    if side * SUBTILE != tile_size:
        raise ValueError(f"tile size {tile_size} is not a multiple of {SUBTILE}")
    tile, slot = _segment_slots(tile_starts, tile_counts)
    rows = table[sorted_ids[slot].long()]
    f32 = torch.float32
    gx = rows[:, 0] - ((tile % tiles_x) * tile_size).to(f32)
    gy = rows[:, 1] - (torch.div(tile, tiles_x, rounding_mode="floor")
                       * tile_size).to(f32)
    opa = torch.where(rows[:, 10] > 0, rows[:, 5], torch.zeros_like(rows[:, 5]))
    touch = torch.zeros((side * side, sorted_ids.shape[0]), dtype=torch.bool,
                        device=dev)
    for q in range(side * side):
        rcx = float((q % side) * SUBTILE) + 0.5 * (SUBTILE - 1)
        rcy = float((q // side) * SUBTILE) + 0.5 * (SUBTILE - 1)
        touch[q, slot] = subtile_keep(gx, gy, rows[:, 2], rows[:, 3], rows[:, 4],
                                      opa, rcx, rcy)
    return touch


def _check_bwd(gc4, g2, num_tiles, tile_size, mode):
    npix = tile_size * tile_size
    if mode not in BWD_ROWS:
        raise ValueError(f"mode must be one of {tuple(BWD_ROWS)}, got {mode!r}")
    if gc4.dtype != torch.float32 or tuple(gc4.shape) != (num_tiles, 4, npix):
        raise ValueError(f"gc4 must be ({num_tiles}, 4, {npix}) float32, got "
                         f"{tuple(gc4.shape)} {gc4.dtype}")
    if g2.dtype != torch.float32 or tuple(g2.shape) != (num_tiles, npix):
        raise ValueError(f"g2 must be ({num_tiles}, {npix}) float32, got "
                         f"{tuple(g2.shape)} {g2.dtype}")


def composite_bwd(table, sorted_ids, tile_starts, tile_counts, gc4, g2,
                  tiles_x: int, tiles_y: int, tile_size: int,
                  mode: str = "full") -> torch.Tensor:
    """Per-slot compositing gradients, (P, BWD_ROWS[mode]): row s holds the
    sums over its tile's pixels for sorted slot s.  Slots that no tile
    composites (dead, past the per-tile cap, or past the tile's early exit)
    are zero.  The per-gaussian sum over a gaussian's slots is the
    caller's (``composite.slots_to_gaussians``)."""
    num_tiles = tiles_x * tiles_y
    _check_inputs(table, sorted_ids, tile_starts, tile_counts, num_tiles)
    _check_bwd(gc4, g2, num_tiles, tile_size, mode)
    dev = table.device
    if dev.type == "cpu":
        return composite_bwd_plain(table, sorted_ids, tile_starts, tile_counts,
                                   gc4, g2, tiles_x, tiles_y, tile_size, mode)
    if dev.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {dev}")
    _check_cuda(tile_size, table, sorted_ids, tile_starts, tile_counts, gc4, g2)
    lib = build(MAIN_KERNELS)["composite_bwd"].lib
    out = torch.zeros((sorted_ids.shape[0], BWD_ROWS[mode]),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gd_composite_bwd(
            table.data_ptr(), sorted_ids.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), gc4.data_ptr(), g2.data_ptr(),
            out.data_ptr(), num_tiles, tiles_x, tile_size,
            _BWD_MODE_ID[mode], stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err}")
    launch_counts["composite_bwd"] += 1
    return out


def composite_bwd_plain(table, sorted_ids, tile_starts, tile_counts, gc4, g2,
                        tiles_x: int, tiles_y: int, tile_size: int,
                        mode: str = "full", stats: dict | None = None,
                        touch: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, with the semantics of
    the JAX ``_xla_bwd``: chunks of CHUNK slots of every tile are gathered
    and their alpha computed as one (T, CHUNK, ts²) block as in the forward's
    plain version; the transmittance and the prefix of contrib · w then step
    slot by slot in the kernel's order and rounding, and each slot's rows
    are summed over the tile's pixels (in another order than the kernel's
    shuffle tree, so the two agree to rounding, not bitwise).

    ``touch`` and ``stats`` as in ``composite_fwd_plain``."""
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

    P = sorted_ids.shape[0]
    out = torch.zeros((P, BWD_ROWS[mode]), dtype=f32, device=dev)
    T = torch.ones((num_tiles, npix), dtype=f32, device=dev)
    prefix = torch.zeros((num_tiles, npix), dtype=f32, device=dev)
    alive = torch.ones((num_tiles, npix), dtype=torch.bool, device=dev)
    gr, gg, gb, gd = gc4.unbind(1)
    zero = torch.zeros((), dtype=f32, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_kept = torch.zeros((), dtype=torch.int64, device=dev)
    n_contrib = torch.zeros((), dtype=torch.int64, device=dev)
    q_of_pixel = None if touch is None else _subtile_of_pixel(ts, dev)

    starts = tile_starts.long()[:, None]
    counts = tile_counts.long()[:, None]
    max_count = int(tile_counts.max()) if num_tiles else 0
    k = torch.arange(CHUNK, device=dev)[None, :]
    for c0 in range(0, max_count, CHUNK):
        in_range = (c0 + k) < counts                            # (T, K)
        slot = torch.clamp(starts + c0 + k, max=max(P - 1, 0))
        rows = table[sorted_ids[slot].long()]                   # (T, K, 12)
        gx0 = (rows[..., 0] - ox)[..., None]
        gy0 = (rows[..., 1] - oy)[..., None]
        a, b, c = (rows[..., i][..., None] for i in (2, 3, 4))
        opa = torch.where(in_range & (rows[..., 10] > 0), rows[..., 5],
                          torch.zeros_like(rows[..., 5]))[..., None]
        dx = px - gx0                                           # (T, K, npix)
        dy = py - gy0
        power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy,
                            max=0.0)
        alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
        hit = (alpha >= ALPHA_MIN) & in_range[..., None]
        kept = None if touch is None else _touch_mask(touch, slot, q_of_pixel)
        if kept is not None:
            hit = hit & kept
        for j in range(min(CHUNK, max_count - c0)):
            a_j = alpha[:, j]
            if stats is not None:
                live = alive & in_range[:, j:j + 1]
                n_eval += live.sum()
                if kept is not None:
                    n_kept += (live & kept[:, j]).sum()
            use = alive & hit[:, j]
            one_m = 1.0 - a_j
            U = T * one_m
            stop = use & (U < T_EPS)
            alive = alive & ~stop
            take = use & ~stop
            w = torch.where(take, a_j * T, zero)
            col = rows[:, j, :, None]                           # (T, 12, 1)
            contrib = gr * col[:, 6] + gg * col[:, 7] + gb * col[:, 8] + gd * col[:, 9]
            prefix = torch.where(take, prefix + contrib * w, prefix)
            suffix = g2 - prefix
            inv_1ma = 1.0 / torch.clamp(one_m, min=1.0 - ALPHA_MAX)
            g_alpha = contrib * T - suffix * inv_1ma
            g_power = torch.where(take & (a_j < ALPHA_MAX), g_alpha * a_j, zero)
            dxj, dyj = dx[:, j], dy[:, j]
            aj, bj, cj = a[:, j], b[:, j], c[:, j]
            gx = g_power * (aj * dxj + bj * dyj)
            gy = g_power * (cj * dyj + bj * dxj)
            if mode == "selonly":
                cols = [gx.abs(), gy.abs()]
            else:
                gh = g_power * -0.5
                cols = [gx, gy, gh * dxj * dxj, g_power * (-dxj * dyj),
                        gh * dyj * dyj, g_power, w * gr, w * gg, w * gb, w * gd]
                if mode == "full":
                    cols += [gx.abs(), gy.abs()]
            vals = torch.stack([v.sum(-1) for v in cols], dim=-1)   # (T, W)
            if mode != "selonly":
                vals[:, 5] = vals[:, 5] / torch.clamp(col[:, 5, 0], min=1e-12)
            ok = in_range[:, j]
            out[slot[ok, j]] = vals[ok]
            T = torch.where(take, U, T)
            if stats is not None:
                n_contrib += take.sum()
    if stats is not None:
        stats["evals"] = int(n_eval)
        if touch is not None:
            stats["evals_kept"] = int(n_kept)
        stats["contribs"] = int(n_contrib)
    return out


# ---------------------------------------------------------------------------
# slot reductions (the per-slot gradient rows -> per-gaussian sums)
# ---------------------------------------------------------------------------


def _check_f32_2d(name, x):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name} must be 2-D float32, got {tuple(x.shape)} "
                         f"{x.dtype}")


def _cuda_ready(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous and on one device")
    return dev


def reduce_slots(rows, n: int, d: int) -> torch.Tensor:
    """Sum groups of ``d`` consecutive rows: (n·d, w) -> (n, w), each output
    the sum of its d rows in increasing order."""
    _check_f32_2d("rows", rows)
    if rows.shape[0] != n * d:
        raise ValueError(f"rows must have n·d = {n * d} rows, got {rows.shape[0]}")
    if rows.device.type == "cpu":
        return reduce_slots_plain(rows, n, d)
    dev = _cuda_ready("reduce_slots", rows)
    lib = build(MAIN_KERNELS)["reduce_slots"].lib
    w = rows.shape[1]
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gd_reduce_slots(rows.data_ptr(), out.data_ptr(), n, d, w,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"reduce_slots launch failed: CUDA error {err}")
    launch_counts["reduce_slots"] += 1
    return out


def reduce_slots_plain(rows, n: int, d: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the d rows of each group added
    one after the other, the kernel's order."""
    per = rows.reshape(n, d, rows.shape[1])
    acc = per[:, 0]
    for k in range(1, d):
        acc = acc + per[:, k]
    return acc.contiguous()


def transpose_rows(cols) -> torch.Tensor:
    """Exact transpose (w, M) -> (M, w)."""
    _check_f32_2d("cols", cols)
    if cols.device.type == "cpu":
        return transpose_rows_plain(cols)
    dev = _cuda_ready("transpose_rows", cols)
    lib = build(MAIN_KERNELS)["transpose_rows"].lib
    w, M = cols.shape
    out = torch.empty((M, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gd_transpose_rows(cols.data_ptr(), out.data_ptr(), w, M,
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transpose_rows launch failed: CUDA error {err}")
    launch_counts["transpose_rows"] += 1
    return out


def transpose_rows_plain(cols) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the w input rows become the
    output's columns."""
    return torch.stack(list(cols), dim=1)

"""k-nearest-neighbor mean squared distance (simple_knn ``distCUDA2``), PyTorch.

Port of ``generativedensification_tpu/core/knn.py``: the mean squared
distance of each point to its 3 nearest neighbors, the scale anchor of a
point-cloud Gaussian init.  Chunked pairwise distances
``|q|² − 2 q·p + |p|²`` with a ``torch.topk`` per chunk: O(N²) operations
in plain PyTorch (the JAX function is XLA, not a Pallas kernel), memory
bounded by the chunk.

The expansion cancels for near neighbors, so its rounding decides the
small distances: the squared norms and the 3-term dot products are
chains of fused multiply-adds (each rounded once; emulated through f64),
as XLA compiles the JAX function.
"""

from __future__ import annotations

import torch


def _fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of a·b (3 terms, broadcast) as the chain
    fma(a2, b2, fma(a1, b1, a0·b0)), each step rounded once to f32."""
    acc = a[..., 0] * b[..., 0]
    for j in (1, 2):
        acc = (a[..., j].double() * b[..., j].double() + acc.double()).float()
    return acc


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """(N, 3) -> (N,) mean squared distance to the k nearest neighbors (the
    point itself excluded; negative rounding clamped to 0)."""
    pts = points.to(torch.float32)
    N = pts.shape[0]
    sq = _fma_dot(pts, pts)
    out = []
    for i in range(0, N, chunk):
        q = pts[i:i + chunk]
        d2 = (sq[i:i + chunk, None] - 2.0 * _fma_dot(q[:, None], pts[None])) + sq[None, :]
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + i] = float("inf")                # exclude self
        near = torch.topk(d2, k, dim=-1, largest=False).values
        out.append(torch.clamp(near, min=0.0).mean(dim=-1))
    return torch.cat(out)

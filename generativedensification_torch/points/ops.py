"""Masked batched point ops: the segment-op replacements, PyTorch.

Port of ``generativedensification_tpu/points/ops.py``: every segment
primitive of the reference reduces to a masked op over the dense
``(B, N, ...)`` layout, and the batched ``top_k`` to :func:`topk_split`
with a static k and order-preserving index sets.
"""

from __future__ import annotations

import torch

# not -inf: a fully masked window must stay finite through the softmax
NEG_INF = -1e30


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean of x over ``dim`` counting only masked-in entries."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    s = (x * m).sum(dim)
    n = torch.clamp(m.sum(dim), min=1.0)
    return s / n


def masked_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-point channel LayerNorm without affine parameters (the
    decoder's ``ln_layer``; eps 1e-5, not the ViT's 1e-6)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over ``dim`` with invalid entries excluded (prob 0)."""
    z = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    z = z - z.amax(dim, keepdim=True).detach()
    e = torch.exp(z) * mask.to(logits.dtype)
    return e / torch.clamp(e.sum(dim, keepdim=True), min=1e-20)


def _top_k_indices(s: torch.Tensor, k: int) -> torch.Tensor:
    """The first k of a STABLE descending sort: ``jax.lax.top_k``'s order,
    ties broken by the lower index (``torch.topk`` leaves tie order
    unspecified, and ties are common here: unseen Gaussians score exactly
    0, the pool pads with -1)."""
    return torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]


def topk_mask(score: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) scores -> (B, N) bool mask of the per-sample top-k valid."""
    s = torch.where(mask, score, torch.full_like(score, NEG_INF))
    out = torch.zeros_like(mask)
    out.scatter_(1, _top_k_indices(s, k), True)
    return out & mask


def topk_split(score: torch.Tensor, mask: torch.Tensor, k: int):
    """Split N points into per-sample (top-k, rest) index sets, both in the
    original point order.

    Returns top_idx (B, k), rest_idx (B, N-k) int64 and their validity
    (B, k), (B, N-k) bool."""
    B, N = score.shape
    s = torch.where(mask, score, torch.full_like(score, NEG_INF))
    top_idx = torch.sort(_top_k_indices(s, k), dim=1).values
    is_top = torch.zeros((B, N), dtype=torch.int32, device=score.device)
    is_top.scatter_(1, top_idx, 1)
    # stable argsort of is_top: the rest first, original order preserved
    rest_idx = torch.sort(is_top, dim=1, stable=True).indices[:, : N - k]
    take = lambda i: torch.gather(mask, 1, i)
    return top_idx, rest_idx, take(top_idx), take(rest_idx)


def top_p_mask(prob: torch.Tensor, mask: torch.Tensor, ratio: float) -> torch.Tensor:
    """Nucleus mask: per-sample descending-sorted inclusive cumsum of
    probs <= ratio, full size with validity (static shapes)."""
    neg = torch.where(mask, prob, torch.full_like(prob, NEG_INF))
    order = torch.sort(-neg, dim=1, stable=True).indices
    p_sorted = torch.gather(torch.where(mask, prob, torch.zeros_like(prob)), 1, order)
    nuc_sorted = torch.cumsum(p_sorted.to(torch.float32), dim=1) <= ratio
    nucleus = torch.zeros_like(mask)
    nucleus.scatter_(1, order, nuc_sorted)
    return nucleus & mask


def straight_through(feat: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """``MaskModule``'s straight-through estimator: value = feat (as
    ``(feat - soft) + soft`` rounds it), gradient through feat * prob."""
    soft = feat * prob[..., None]
    return (feat - soft).detach() + soft


def straight_through_res(feat: torch.Tensor, prob: torch.Tensor,
                         hard: torch.Tensor) -> torch.Tensor:
    """Residual-path straight-through: value = feat * hard_mask, gradient
    through feat * prob."""
    soft = feat * prob[..., None]
    hardv = feat * hard[..., None].to(feat.dtype)
    return (hardv - soft).detach() + soft

"""ViT-B/16 image encoder (DINO v1 architecture), PyTorch.

Port of ``generativedensification_tpu/models/vit.py``: 16x16 conv patch
embed, prepended CLS token, learned positional embeddings on a 14x14 base
grid resized bicubically for other resolutions, pre-norm blocks (MLP x4,
LayerNorm eps 1e-6, tanh-approximate GELU as flax's ``nn.gelu``).
Sub-module names follow the Flax tree so the weight bridge
(``utils/convert.py``) is a mechanical renaming.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .init import init_module_, normal_, remat_call
from .precision import F32, conv, dense, gelu, layer_norm, logits_f32, weak

DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weight_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in, out) weights of ``jax.image.resize(..., "bicubic")`` along one
    axis: half-pixel centres, weights renormalised at the borders, and the
    kernel widened by the scale when downsampling (antialiasing) — the
    construction of JAX's ``compute_weight_mat``, in float32."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.0 * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]
         ).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(grid: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(h, w, C) -> (out_h, out_w, C), as two small matmuls."""
    h, w, _ = grid.shape
    if h != out_h:
        grid = torch.einsum("hwc,hH->Hwc", grid,
                            resize_weight_matrix(h, out_h, grid.device))
    if w != out_w:
        grid = torch.einsum("hwc,wW->hWc", grid,
                            resize_weight_matrix(w, out_w, grid.device))
    return grid


class BlockedSelfAttention(nn.Module):
    """Multi-head self-attention, one matmul + f32 softmax per head (the JAX
    module computes the same in query blocks; blocking does not change the
    values).  Projections in ``dtype``, logits in f32."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = F32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        B, L, C = x.shape
        H = self.num_heads
        Dh = C // H
        dt = self.dtype
        q = dense(self.query, x, dt).view(B, L, H, Dh)
        q = q / weak(math.sqrt(Dh), q)
        k = dense(self.key, x, dt).view(B, L, H, Dh)
        v = dense(self.value, x, dt).view(B, L, H, Dh)
        logits = logits_f32("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return dense(self.out, out.reshape(B, L, C), dt)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = BlockedSelfAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        dt = self.dtype
        x = x + self.attn(layer_norm(self.norm1, x, dt))
        h = dense(self.mlp_fc1, layer_norm(self.norm2, x, dt), dt)
        return x + dense(self.mlp_fc2, gelu(h), dt)


class VisionTransformer(nn.Module):
    """Patch-embed ViT returning all tokens (CLS first): patch embed and
    blocks in ``dtype``, the final LayerNorm in f32 (its tokens feed the f32
    volume lift)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 base_grid: int = 14, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.dim = dim
        self.base_grid = base_grid
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, base_grid * base_grid + 1, dim))
        self.blocks = nn.ModuleList(
            ViTBlock(dim, num_heads, mlp_ratio, dtype) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_module_(self, gen)
        nn.init.zeros_(self.cls_token)
        normal_(self.pos_embed, 0.02, gen)

    def forward(self, images):
        """images: (B, H, W, 3) already normalized -> (B, 1+L, dim)."""
        B, H, W, _ = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = conv(self.patch_embed, images.permute(0, 3, 1, 2), self.dtype)
        x = x.permute(0, 2, 3, 1).reshape(B, gh * gw, self.dim)
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (self.base_grid, self.base_grid):
            grid_pos = resize_bicubic(
                grid_pos.reshape(self.base_grid, self.base_grid, self.dim), gh, gw
            ).reshape(1, gh * gw, self.dim)
        x = x + grid_pos.to(x.dtype)
        cls_tok = (self.cls_token + cls_pos).expand(B, 1, self.dim).to(x.dtype)
        x = torch.cat([cls_tok, x], dim=1)
        for blk in self.blocks:
            x = remat_call(blk, x)  # recomputed in the backward
        return self.norm(x.to(F32))


VIT_VARIANTS = {  # name fragment -> (dim, depth, heads)
    "vit_base": (768, 12, 12),
    "vit_small": (384, 12, 6),
    "tiny_test": (32, 1, 2),   # CPU-test stub
}


class DinoEncoder(nn.Module):
    """Normalize [0, 1] RGB, encode, drop the CLS token."""

    def __init__(self, variant: str = "vit_base_patch16_224.dino",
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        for key, (dim, depth, heads) in VIT_VARIANTS.items():
            if key in variant:
                break
        else:
            raise NotImplementedError(f"unknown ViT variant {variant!r}")
        self.num_features = dim
        self.vit = VisionTransformer(dim=dim, depth=depth, num_heads=heads,
                                     dtype=dtype)
        self.register_buffer("mean", torch.tensor(DINO_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(DINO_STD), persistent=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.vit.reset_parameters(gen)

    def forward(self, images):
        """images: (B, H, W, 3) in [0, 1] -> (B, L, C) patch tokens."""
        return self.vit(((images - self.mean) / self.std).to(self.dtype))[:, 1:]

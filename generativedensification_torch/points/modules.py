"""Modules of the point-serialization densification decoder, PyTorch.

Port of ``generativedensification_tpu/points/modules.py`` over the dense
batched :class:`~.structure.PointSet`, for the serving path (no dropout or
drop-path: the train-time forms arrive with ROADMAP slice 4):

  * ``WindowAttention`` — windowed attention over one serialized order;
    every point budget is a multiple of the patch size, so it is a plain
    ``(B, nWin, H, K, D)`` f32 attention with invalid keys masked.
  * ``NeighborConvCPE`` — the submanifold 3³ conv (xCPE) as a gather of the
    27 neighbor rows and one contraction with the ``(27, C, C)`` kernel.
  * ``Block``, ``UpscaleModule``, ``MaskModule``, ``MaskResModule``,
    ``GaussianModule`` and ``PDNorm`` mirror the JAX modules.

Sub-module names follow the Flax tree (``utils/convert.py`` maps weights).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .ops import (
    NEG_INF,
    masked_layer_norm,
    masked_mean,
    masked_softmax,
    straight_through,
    straight_through_res,
    top_p_mask,
    topk_split,
)
from .structure import PointSet, gather_points, gather_rows


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class PDNorm(nn.Module):
    """Prompt-driven normalization: a per-condition affine over the shared
    parameter-free LayerNorm statistics (decouple=True, adaptive=False)."""

    def __init__(self, dim: int, n_conditions: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n_conditions, dim))
        self.bias = nn.Parameter(torch.zeros(n_conditions, dim))

    def forward(self, x: torch.Tensor, condition: int = 0) -> torch.Tensor:
        return masked_layer_norm(x) * self.weight[condition] + self.bias[condition]


def _norm(module: PDNorm | None, x: torch.Tensor, condition: int) -> torch.Tensor:
    return masked_layer_norm(x) if module is None else module(x, condition)


class PointMLP(nn.Module):
    """fc1 - gelu - fc2."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    """Windowed attention over one serialized order (window = patch_size)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 order_index: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.qk_scale = qk_scale
        self.order_index = order_index
        self.qkv = nn.Linear(channels, 3 * channels, bias=qkv_bias)
        self.proj = nn.Linear(channels, channels)

    def forward(self, ps: PointSet) -> torch.Tensor:
        B, N, C = ps.feat.shape
        H, K = self.num_heads, self.patch_size
        D = C // H
        if N % K:
            raise ValueError(f"point budget {N} must be a multiple of patch {K}")
        nw = N // K
        scale = self.qk_scale or D ** -0.5
        order = ps.orders[self.order_index]
        inverse = ps.inverses[self.order_index]

        qkv = gather_rows(self.qkv(ps.feat), order)
        kmask = torch.gather(ps.mask, 1, order)
        qkv = qkv.reshape(B, nw, K, 3, H, D).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]                 # (B, nw, H, K, D)
        attn = torch.matmul(q * scale, k.transpose(-1, -2))
        attn = torch.where(kmask.reshape(B, nw, 1, 1, K), attn,
                           torch.full_like(attn, NEG_INF))
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v)
        out = out.permute(0, 1, 3, 2, 4).reshape(B, N, C)
        return self.proj(gather_rows(out, inverse))


def neighbor_conv27(feat: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y[b,n] = Σ_o feat[b, nbr[b,n,o]] @ w[o]`` (a miss, ``nbr < 0``,
    contributes zero): one gather of the 27 neighbor rows and one
    (N, 27·C) x (27·C, D) product.  Forward only."""
    B, N, C = feat.shape
    g = gather_rows(feat, nbr.clamp(min=0).reshape(B, N * 27)).reshape(B, N, 27, C)
    g = torch.where((nbr >= 0)[..., None], g, torch.zeros_like(g))
    return torch.matmul(g.reshape(B, N, 27 * C), w.reshape(27 * C, -1))


class NeighborConvCPE(nn.Module):
    """xCPE: submanifold 3³ conv + Linear + LN.  ``weight`` keeps the Flax
    kernel's (27, C_in, C_out) layout."""

    def __init__(self, channels: int, pdnorm_n: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(27, channels, channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.linear = nn.Linear(channels, channels)
        self.norm = PDNorm(channels, pdnorm_n) if pdnorm_n else None

    def forward(self, ps: PointSet) -> torch.Tensor:
        y = neighbor_conv27(ps.feat, ps.neighbor_idx, self.weight) + self.bias
        return _norm(self.norm, self.linear(y), ps.condition)


class Block(nn.Module):
    """PTv3 block: CPE residual, pre-norm attention residual, pre-norm MLP
    residual."""

    def __init__(self, channels: int, num_heads: int, patch_size: int = 48,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, pre_norm: bool = True,
                 order_index: int = 0, pdnorm_n: int = 0):
        super().__init__()
        self.pre_norm = pre_norm
        self.cpe = NeighborConvCPE(channels, pdnorm_n)
        self.attn = WindowAttention(channels, num_heads, patch_size, qkv_bias,
                                    qk_scale, order_index)
        self.mlp = PointMLP(channels, int(channels * mlp_ratio), channels)
        self.norm1 = PDNorm(channels, pdnorm_n) if pdnorm_n else None
        self.norm2 = PDNorm(channels, pdnorm_n) if pdnorm_n else None

    def forward(self, ps: PointSet) -> PointSet:
        norm1 = lambda x: _norm(self.norm1, x, ps.condition)
        norm2 = lambda x: _norm(self.norm2, x, ps.condition)
        feat = ps.feat
        feat = feat + self.cpe(ps.replace(feat=feat))

        shortcut = feat
        x = norm1(feat) if self.pre_norm else feat
        feat = shortcut + self.attn(ps.replace(feat=x))
        if not self.pre_norm:
            feat = norm1(feat)

        shortcut = feat
        x = norm2(feat) if self.pre_norm else feat
        feat = shortcut + self.mlp(x)
        if not self.pre_norm:
            feat = norm2(feat)
        return ps.replace(feat=feat)


def global_pooling(ps: PointSet) -> PointSet:
    """Per-sample masked mean -> ``global_feat``."""
    return ps.replace(global_feat=masked_mean(ps.feat, ps.mask))


def positional_encoding(freqs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sin/cos PE, (.., 3) -> (.., 2·3·n_freq), frequency-major."""
    fx = (freqs[:, None] * x[..., None, :]).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(fx), torch.cos(fx)], dim=-1)


class UpscaleModule(nn.Module):
    """Learned S×N upsampling: each parent emits S children at
    ``coord + 0.5·grid_size·tanh(delta_x)`` with features
    ``skip(parent) + delta_f([PE(dx), parent])``."""

    def __init__(self, in_channels: int, out_channels: int, upscale_factor: int,
                 n_frequencies: int = 15, enable_absolute_pe: bool = False,
                 carry_attribute: bool = False, pdnorm_n: int = 0):
        super().__init__()
        C, S = in_channels, upscale_factor
        self.upscale_factor = S
        self.n_frequencies = n_frequencies
        self.enable_absolute_pe = enable_absolute_pe
        self.carry_attribute = carry_attribute
        self.delta_x_fc1 = nn.Linear(C, C)
        self.delta_x_fc2 = nn.Linear(C, 3 * S)
        df_in = (6 * n_frequencies if n_frequencies > 0 else 3) + C
        self.delta_f_fc1 = nn.Linear(df_in, C)
        self.delta_f_fc2 = nn.Linear(C, out_channels)
        self.skip = nn.Linear(C, out_channels)
        self.in_norm = PDNorm(C, pdnorm_n) if pdnorm_n else None
        self.out_norm = PDNorm(out_channels, pdnorm_n) if pdnorm_n else None

    def forward(self, ps: PointSet) -> PointSet:
        S = self.upscale_factor
        B, N, _ = ps.feat.shape
        feat = _norm(self.in_norm, ps.feat, ps.condition)
        delta_x = self.delta_x_fc2(gelu(self.delta_x_fc1(feat)))
        delta_x = 0.5 * ps.grid_size * torch.tanh(delta_x.reshape(B, N * S, 3))

        skip_x = torch.repeat_interleave(ps.coord, S, dim=1)
        skip_f = torch.repeat_interleave(feat, S, dim=1)
        out_x = skip_x + delta_x
        if self.n_frequencies > 0:
            freqs = 2.0 ** torch.arange(self.n_frequencies, dtype=torch.float32,
                                        device=feat.device)
            pe = positional_encoding(freqs, out_x if self.enable_absolute_pe else delta_x)
            df_in = torch.cat([pe, skip_f], dim=-1)
        else:
            df_in = torch.cat([delta_x, skip_f], dim=-1)
        df = self.delta_f_fc1(masked_layer_norm(df_in))
        out_f = self.skip(skip_f) + self.delta_f_fc2(gelu(df))
        out_f = _norm(self.out_norm, out_f, ps.condition)

        attribute = ps.attribute
        if self.carry_attribute and attribute is not None:
            attribute = torch.repeat_interleave(attribute, S, dim=1)
        return ps.replace(
            coord=out_x, feat=out_f, mask=torch.repeat_interleave(ps.mask, S, dim=1),
            attribute=attribute, orders=None, inverses=None, grid_coord=None,
            neighbor_idx=None, prob=None,
        )


def _check_sampling(kind: str) -> None:
    if kind not in ("topk", "top_p"):
        raise NotImplementedError(
            f"mask_sampling_type={kind!r}; supported: topk, top_p")


class MaskModule(nn.Module):
    """Non-residual densification gate: sigmoid-prob MLP, straight-through
    feature scaling, static top-k split into (non_leaf, leaf).  With
    ratio >= 1 every point is both (terminal level) and there are no
    parameters."""

    def __init__(self, dim: int, temperature: float = 1.0,
                 non_leaf_ratio: float = 1.0, mask_sampling_type: str = "topk"):
        super().__init__()
        self.non_leaf_ratio = non_leaf_ratio
        self.mask_sampling_type = mask_sampling_type
        if non_leaf_ratio < 1.0:
            self.net_fc1 = nn.Linear(dim, dim)
            self.net_fc2 = nn.Linear(dim, 1)

    def forward(self, ps: PointSet):
        if self.non_leaf_ratio >= 1.0:
            return ps, ps
        _check_sampling(self.mask_sampling_type)
        N = ps.feat.shape[1]
        prob = torch.sigmoid(self.net_fc2(gelu(self.net_fc1(ps.feat)))[..., 0])
        ps = ps.replace(feat=straight_through(ps.feat, prob), prob=prob)
        if self.mask_sampling_type == "top_p":
            nucleus = top_p_mask(prob, ps.mask, self.non_leaf_ratio)
            return ps.replace(mask=nucleus), ps.replace(mask=ps.mask & ~nucleus)
        k = int(-(-N * self.non_leaf_ratio // 1))  # ceil
        top_idx, rest_idx, top_ok, rest_ok = topk_split(prob, ps.mask, k)
        return (gather_points(ps, top_idx, new_mask=top_ok),
                gather_points(ps, rest_idx, new_mask=rest_ok))


class MaskResModule(nn.Module):
    """Residual-path gate: per-sample softmax prob with temperature and a
    hard-mask straight-through.  Returns (ps, split indices or None,
    non_leaf mask or None); the caller splits."""

    def __init__(self, dim: int, temperature: float = 1.0,
                 non_leaf_ratio: float = 1.0, mask_sampling_type: str = "topk"):
        super().__init__()
        self.temperature = temperature
        self.non_leaf_ratio = non_leaf_ratio
        self.mask_sampling_type = mask_sampling_type
        if non_leaf_ratio < 1.0:
            self.net_fc1 = nn.Linear(dim, dim)
            self.net_fc2 = nn.Linear(dim, 1)

    def forward(self, ps: PointSet):
        if self.non_leaf_ratio >= 1.0:
            return ps, None, None
        _check_sampling(self.mask_sampling_type)
        B, N, _ = ps.feat.shape
        raw = self.net_fc2(gelu(self.net_fc1(ps.feat)))[..., 0]
        prob = masked_softmax(raw / self.temperature, ps.mask, dim=1)
        if self.mask_sampling_type == "top_p":
            non_leaf = top_p_mask(prob, ps.mask, self.non_leaf_ratio)
            feat = straight_through_res(ps.feat, prob, non_leaf)
            return ps.replace(feat=feat, prob=prob), None, non_leaf
        k = int(-(-N * self.non_leaf_ratio // 1))
        top_idx, rest_idx, _, _ = topk_split(prob, ps.mask, k)
        non_leaf = torch.zeros_like(ps.mask).scatter_(1, top_idx, True) & ps.mask
        feat = straight_through_res(ps.feat, prob, non_leaf)
        return ps.replace(feat=feat, prob=prob), (top_idx, rest_idx), non_leaf


class GaussianModule(nn.Module):
    """Per-point attribute head: dim -> dim -> num_sh + 1 + 3 + 4."""

    def __init__(self, dim: int, sh_degree: int = 1):
        super().__init__()
        self.feat2attr_fc1 = nn.Linear(dim, dim)
        self.feat2attr_fc2 = nn.Linear(dim, 3 * (sh_degree + 1) ** 2 + 8)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.feat2attr_fc2(gelu(self.feat2attr_fc1(feat)))


def split_attributes(attr: torch.Tensor, sh_degree: int):
    """attribute (..., A) -> (sh, opacity, scale, rotation) slices."""
    num_sh = 3 * (sh_degree + 1) ** 2
    return (attr[..., :num_sh], attr[..., num_sh: num_sh + 1],
            attr[..., num_sh + 1: num_sh + 4], attr[..., num_sh + 4: num_sh + 8])

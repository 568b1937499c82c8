"""LaRa-style volume transformer backbone + Gaussian decoder heads, PyTorch.

Port of ``generativedensification_tpu/models/backbone.py``.  Tensors stay
channels-last at every public function, as in the JAX package; the 3D
convolutions permute to channels-first around the torch op.  Sub-module
names follow the Flax tree (``utils/convert.py`` maps the weights).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .init import init_module_, normal_, remat_call, xavier_uniform_
from .precision import F32, conv, dense, gelu, layer_norm, logits_f32

LN_EPS = 1e-6


# --------------------------------------------------------------------------
# geometry helpers
# --------------------------------------------------------------------------


def build_dense_grid(reso: int, scene_size: float = 0.5, device=None) -> torch.Tensor:
    """(reso³, 3) voxel-center world coordinates in ±scene_size."""
    a = (torch.arange(reso, dtype=torch.float32, device=device) + 0.5) / reso * 2.0 - 1.0
    g = torch.stack(torch.meshgrid(a, a, a, indexing="ij"), dim=-1)
    return (g * scene_size).reshape(-1, 3)


def project_points(points, w2cs, ixts):
    """points (..., 3), w2cs (V, 4, 4), ixts (V, 3, 3) -> xy (V, M, 2) pixel
    coords and z (V, M, 1) view depth."""
    p = torch.einsum("nc,vdc->vnd", points.reshape(-1, 3), w2cs[:, :3, :3])
    p = p + w2cs[:, None, :3, 3]
    p = torch.einsum("vnc,vdc->vnd", p, ixts)
    return p[..., :2] / p[..., 2:3], p[..., 2:3]


def bilinear_sample(img: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """Batched ``F.grid_sample(align_corners=False, zeros padding)``
    equivalent in channels-last layout.

    img (B, H, W, C); xy_norm (B, M, 2) in [-1, 1] -> (B, M, C).
    """
    B, H, W, C = img.shape
    x = ((xy_norm[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((xy_norm[..., 1] + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = img.reshape(B, H * W, C)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = torch.clamp(xi, 0, W - 1).long()
        yi_c = torch.clamp(yi, 0, H - 1).long()
        idx = (yi_c * W + xi_c)[..., None].expand(*xi.shape, C)
        v = torch.gather(flat, 1, idx)
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    return (
        tap(x0, y0) * (1 - wx) * (1 - wy)
        + tap(x0 + 1, y0) * wx * (1 - wy)
        + tap(x0, y0 + 1) * (1 - wx) * wy
        + tap(x0 + 1, y0 + 1) * wx * wy
    )


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


class ModLN(nn.Module):
    """adaLN modulation: ``LN(x) * (1 + scale) + shift`` with shift/scale
    from SiLU+Linear over the conditioning, computed in ``dtype``."""

    def __init__(self, inner_dim: int, cond_dim: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.mlp = nn.Linear(cond_dim, inner_dim * 2)
        self.norm = nn.LayerNorm(inner_dim, eps=LN_EPS)

    def forward(self, x, cond):
        dt = self.dtype
        shift, scale = dense(self.mlp, F.silu(cond).to(dt), dt).chunk(2, dim=-1)
        return layer_norm(self.norm, x, dt) * (1 + scale) + shift


class CrossAttention(nn.Module):
    """Multi-head cross-attention with separate kv input dim, no biases;
    projections in ``dtype``, logits and softmax in f32."""

    def __init__(self, dim: int, num_heads: int, kv_dim: int, use_bias: bool = False,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = nn.Linear(dim, dim, bias=use_bias)
        self.k = nn.Linear(kv_dim, dim, bias=use_bias)
        self.v = nn.Linear(kv_dim, dim, bias=use_bias)
        self.out = nn.Linear(dim, dim, bias=use_bias)

    def forward(self, q_in, kv_in):
        H, dt = self.num_heads, self.dtype
        q = dense(self.q, q_in, dt)
        D = q.shape[-1] // H
        q = q.reshape(*q.shape[:-1], H, D)
        k = dense(self.k, kv_in, dt).reshape(*kv_in.shape[:-1], H, D)
        v = dense(self.v, kv_in, dt).reshape(*kv_in.shape[:-1], H, D)
        attn = logits_f32("...qhd,...khd->...hqk", q, k) * (D ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.einsum("...hqk,...khd->...qhd", attn, v)
        return dense(self.out, out.reshape(*out.shape[:-2], H * D), dt)


def _unfold3d(x: torch.Tensor, g: int, bs: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, g³, bs³, C) blocks, group-major/voxel-minor."""
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, g, bs, g, bs, g, bs, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, g ** 3, bs ** 3, C)


def _fold3d(p: torch.Tensor, g: int, bs: int) -> torch.Tensor:
    """Inverse of :func:`_unfold3d`."""
    B, C = p.shape[0], p.shape[-1]
    x = p.reshape(B, g, g, g, bs, bs, bs, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, g * bs, g * bs, g * bs, C)


def _channels_last_conv3d(layer: nn.Module, x: torch.Tensor,
                          dtype: torch.dtype = F32) -> torch.Tensor:
    return conv(layer, x.permute(0, 4, 1, 2, 3), dtype).permute(0, 2, 3, 4, 1)


class GroupAttBlock(nn.Module):
    """Volume transformer layer: per-group cross attention from block voxel
    tokens to that group's image-feature tokens, MLP, then a 3³ conv
    residual over the refolded volume, all in ``dtype``."""

    def __init__(self, inner_dim: int, cond_dim: int, num_heads: int,
                 mlp_ratio: float = 2.0, dtype: torch.dtype = F32):
        super().__init__()
        hidden = int(inner_dim * mlp_ratio)
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(inner_dim, eps=LN_EPS)
        self.cross_attn = CrossAttention(inner_dim, num_heads, cond_dim,
                                         dtype=dtype)
        self.norm2 = nn.LayerNorm(inner_dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(inner_dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, inner_dim)
        self.norm3 = nn.LayerNorm(inner_dim, eps=LN_EPS)
        self.cnn = nn.Conv3d(inner_dim, inner_dim, 3, padding=1, bias=False)

    def forward(self, x, cond, group_axis: int, block_size: int):
        """x: (B, D, H, W, C); cond: (B, g³, L_cond, cond_dim)."""
        g, bs, dt = group_axis, block_size, self.dtype
        patches = _unfold3d(x.to(dt), g, bs)
        patches = patches + self.cross_attn(layer_norm(self.norm1, patches, dt),
                                            cond)
        h = dense(self.mlp_fc1, layer_norm(self.norm2, patches, dt), dt)
        patches = patches + dense(self.mlp_fc2, gelu(h), dt)
        vol = _fold3d(layer_norm(self.norm3, patches, dt), g, bs)
        return vol + _channels_last_conv3d(self.cnn, vol, dt)


class VolTransformer(nn.Module):
    """Learned R³ positional volume refined by ``num_layers`` group-attention
    blocks (in ``dtype``), upsampled 2x by a transposed conv (final norm and
    deconv in f32: they feed the f32 Gaussian heads)."""

    def __init__(self, embed_dim: int = 256, image_feat_dim: int = 800,
                 n_groups: tuple = (16,), vol_low_res: int = 32,
                 out_dim: int = 80, num_layers: int = 12, num_heads: int = 16,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.n_groups = tuple(n_groups)
        self.vol_low_res = R = vol_low_res
        self.out_dim = out_dim
        self.pos_embed = nn.Parameter(torch.zeros(1, R, R, R, embed_dim))
        self.layers = nn.ModuleList(
            GroupAttBlock(embed_dim, image_feat_dim, num_heads, dtype=dtype)
            for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.deconv = nn.ConvTranspose3d(embed_dim, out_dim, 2, stride=2)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_module_(self, gen)
        normal_(self.pos_embed, self.embed_dim ** -0.5, gen)

    def forward(self, image_feats):
        """image_feats: (B, V, D, H, W, C_img) -> (B, (2R)³, out_dim)."""
        B, V, D, H, W, C = image_feats.shape
        R = self.vol_low_res
        conds = []
        for n_group in self.n_groups:
            bs = D // n_group
            blk = _unfold3d(image_feats.reshape(B * V, D, H, W, C), n_group, bs)
            blk = blk.reshape(B, V, n_group ** 3, bs ** 3, C).transpose(1, 2)
            conds.append(blk.reshape(B, n_group ** 3, V * bs ** 3, C).to(self.dtype))
        x = self.pos_embed.expand(B, R, R, R, self.embed_dim).to(self.dtype)
        block_sizes = [R // n for n in self.n_groups]
        for i, layer in enumerate(self.layers):
            gi = i % len(self.n_groups)
            # recomputed in the backward
            x = remat_call(layer, x, conds[gi], self.n_groups[gi],
                           block_sizes[gi])
        x = _channels_last_conv3d(self.deconv, self.norm(x.to(F32)))
        return x.reshape(B, -1, self.out_dim)


class GaussianDecoder(nn.Module):
    """Coarse + fine Gaussian attribute heads."""

    def __init__(self, in_dim: int = 80, sh_dim: int = 12, scaling_dim: int = 3,
                 rotation_dim: int = 4, opacity_dim: int = 1, K: int = 1,
                 fine_cond_dim: int = 8, fine_heads: int = 16):
        super().__init__()
        self.in_dim, self.sh_dim, self.K = in_dim, sh_dim, K
        self.scaling_dim, self.rotation_dim = scaling_dim, rotation_dim
        self.opacity_dim = opacity_dim
        self.out_dim = 3 + sh_dim + opacity_dim + scaling_dim + rotation_dim
        self.coarse_fc0 = nn.Linear(in_dim, in_dim)
        self.coarse_fc1 = nn.Linear(in_dim, in_dim)
        self.coarse_out = nn.Linear(in_dim, self.out_dim * K)
        self.fine_norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.fine_cross = CrossAttention(in_dim, fine_heads, fine_cond_dim)
        self.fine_fc0 = nn.Linear(in_dim, in_dim)
        self.fine_out = nn.Linear(in_dim, in_dim + sh_dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_module_(self, gen)
        for m in (self.coarse_fc0, self.coarse_fc1, self.coarse_out,
                  self.fine_fc0, self.fine_out):
            xavier_uniform_(m.weight, m.in_features, m.out_features, gen)

    def coarse(self, feats, opacity_shift: float, scaling_shift: float):
        """(B, N, in_dim) -> offset, sh, scaling, rotation, opacity
        (sigmoid*2-1 offsets, head shifts)."""
        x = F.relu(self.coarse_fc0(feats))
        x = F.relu(self.coarse_fc1(x))
        x = self.coarse_out(x)
        x = x.reshape(*x.shape[:-1], self.K, self.out_dim)
        offset, sh, opacity, scaling, rotation = torch.split(
            x, [3, self.sh_dim, self.opacity_dim, self.scaling_dim,
                self.rotation_dim], dim=-1,
        )
        B = x.shape[0]
        return (
            (torch.sigmoid(offset) * 2.0 - 1.0).reshape(B, -1, 3),
            sh.reshape(B, -1, self.sh_dim // 3, 3),
            (scaling + scaling_shift).reshape(B, -1, self.scaling_dim),
            rotation.reshape(B, -1, self.rotation_dim),
            (opacity + opacity_shift).reshape(B, -1, self.opacity_dim),
        )

    def fine(self, volume_feat, point_feats):
        """(.., M, in_dim) queries vs (.., M, V, 8) per-view samples ->
        (fine feature in_dim, SH residual sh_dim)."""
        q = self.fine_norm(volume_feat)[..., None, :]
        x = self.fine_cross(q, point_feats)[..., 0, :]
        x = self.fine_out(F.relu(self.fine_fc0(x)))
        return x[..., : self.in_dim], x[..., self.in_dim:]

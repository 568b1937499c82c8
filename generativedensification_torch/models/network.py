"""The Generative Densification network, PyTorch: the coarse path.

Port of ``generativedensification_tpu/models/network.py``
``Network.__call__(batch, with_fine=False)``: DINO ViT tokens, Plücker-ray
modulation, a feature volume lifted from the token maps, the group-attention
volume transformer, the coarse Gaussian head on the (2R)³ grid, and every
view rendered through the 3DGS rasterizer (one compositor launch per view).

Not ported yet, each raising ``NotImplementedError`` with the ROADMAP item
that brings it: the fine stage (``with_fine=True``: selection, the
densifier and the fine render — ROADMAP slice 2), the 2DGS renderer
(ROADMAP queue 1, 2DGS) and the bf16 compute policy (ROADMAP slice 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..core.camera import Camera
from ..core.rays import rays_to_plucker
from ..core.sh import rsh_cart
from ..splat.rasterizer import rasterize
from ..utils.device import resolve_device
from .backbone import (
    GaussianDecoder,
    ModLN,
    VolTransformer,
    bilinear_sample,
    build_dense_grid,
    project_points,
)
from .init import init_module_, normal_
from .vit import DinoEncoder


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Static hyperparameters of the coarse path (the JAX ``NetworkConfig``
    fields this slice reads; the fine stage's arrive with ROADMAP slice 2,
    and the TPU data-plane knobs — backend, vmap/remat of renders, the XLA
    chunk — have no meaning here)."""

    n_views: int = 4
    encoder_backbone: str = "vit_base_patch16_224.dino"
    n_groups: tuple = (16,)
    n_offset_groups: int = 32
    K: int = 1
    sh_degree: int = 1
    num_layers: int = 12
    num_heads: int = 16
    view_embed_dim: int = 32
    embedding_dim: int = 256
    vol_feat_reso: int = 16
    vol_embedding_reso: int = 32
    vol_embedding_out_dim: int = 80
    # rasterizer static budgets
    tile_size: int = 32
    max_tiles: int = 4
    max_per_tile: int = 4096
    enum_tiles: int = 0
    pair_budget: float = 0.0
    scene_size: float = 0.5
    compute_dtype: str = "float32"
    renderer: str = "3dgs"

    @classmethod
    def from_config(cls, cfg: Any) -> "NetworkConfig":
        m = cfg.model
        tpu = cfg.get("tpu", {})
        get = lambda node, k, d: node.get(k, d) if hasattr(node, "get") else d
        return cls(
            n_views=cfg.n_views,
            encoder_backbone=m.encoder_backbone,
            n_groups=tuple(m.n_groups),
            n_offset_groups=m.n_offset_groups,
            K=m.K,
            sh_degree=m.sh_degree,
            num_layers=m.num_layers,
            num_heads=m.num_heads,
            view_embed_dim=m.view_embed_dim,
            embedding_dim=m.embedding_dim,
            vol_feat_reso=m.vol_feat_reso,
            vol_embedding_reso=m.vol_embedding_reso,
            vol_embedding_out_dim=m.vol_embedding_out_dim,
            tile_size=get(tpu, "tile_size", cls.tile_size),
            max_tiles=get(tpu, "max_tiles", cls.max_tiles),
            max_per_tile=get(tpu, "max_per_tile", cls.max_per_tile),
            enum_tiles=get(tpu, "enum_tiles", cls.enum_tiles),
            pair_budget=get(tpu, "pair_budget", cls.pair_budget),
            compute_dtype=get(tpu, "compute_dtype", cls.compute_dtype),
            renderer=get(tpu, "renderer", cls.renderer),
        )

    @property
    def sh_dim(self) -> int:
        return 3 * (self.sh_degree + 1) ** 2

    @property
    def voxel_size(self) -> float:
        return 2.0 / (self.vol_embedding_reso * 2)

    @property
    def opacity_shift(self) -> float:
        return -2.1792

    @property
    def scaling_shift(self) -> float:
        return math.log(0.5 * self.voxel_size / 3.0)


class Network(nn.Module):
    """Coarse reconstruction network (``forward(batch, with_fine=False)``).

    ``device=None`` runs on the card (and raises without one); the CPU
    takes only an explicit ``device="cpu"``.  Weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` (Flax-default distributions);
    ``load_flax_params`` replaces them with a JAX parameter tree.
    """

    def __init__(self, cfg: NetworkConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.renderer != "3dgs":
            raise NotImplementedError(
                f"renderer={cfg.renderer!r}: the 2DGS surfel renderer and its "
                "kernels arrive with ROADMAP queue 1 (2DGS renderer)")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the bf16 compute policy "
                "arrives with ROADMAP slice 3 (train step)")
        self.cfg = cfg
        dev = resolve_device(device)
        self.img_encoder = DinoEncoder(cfg.encoder_backbone)
        C = self.img_encoder.num_features
        self.dir_norm = ModLN(C, 2 * 16)     # two degree-3 rsh_cart blocks
        self.view_embed = (
            nn.Parameter(torch.zeros(1, 4, 1, cfg.view_embed_dim))
            if cfg.view_embed_dim > 0 else None
        )
        self.vol_decoder = VolTransformer(
            embed_dim=cfg.embedding_dim,
            image_feat_dim=C + cfg.view_embed_dim,
            n_groups=cfg.n_groups,
            vol_low_res=cfg.vol_embedding_reso,
            out_dim=cfg.vol_embedding_out_dim,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
        )
        self.decoder = GaussianDecoder(
            in_dim=cfg.vol_embedding_out_dim, sh_dim=cfg.sh_dim, K=cfg.K
        )
        self.register_buffer(
            "volume_grid", build_dense_grid(cfg.vol_feat_reso, cfg.scene_size),
            persistent=False)
        self.register_buffer(
            "group_centers",
            build_dense_grid(cfg.vol_embedding_reso * 2, cfg.scene_size),
            persistent=False)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(dev)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.img_encoder.reset_parameters(gen)
        init_module_(self.dir_norm, gen)
        if self.view_embed is not None:
            normal_(self.view_embed, self.cfg.view_embed_dim ** -0.5, gen)
        self.vol_decoder.reset_parameters(gen)
        self.decoder.reset_parameters(gen)

    def load_flax_params(self, params) -> None:
        """Load a JAX ``Network`` parameter tree (nested dicts of arrays,
        with or without the top-level ``"params"`` key) through
        ``utils.convert.state_dict_from_flax``.  Entries of the fine stage
        that the port does not hold yet (the densifier stages) are
        ignored.  The decoder's fine head may be absent (a JAX tree
        initialised with ``with_fine=False`` has none) and then keeps its
        seeded values; every other parameter must be filled."""
        from ..utils.convert import state_dict_from_flax

        sd = state_dict_from_flax(params.get("params", params))
        own = self.state_dict()
        missing = sorted(k for k in set(own) - set(sd)
                         if not k.startswith("decoder.fine_"))
        if missing:
            raise KeyError(f"flax tree lacks parameters: {missing}")
        sd = {k: v for k, v in sd.items() if k in own}
        for k, v in sd.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch at {k}: flax {tuple(v.shape)} "
                                 f"vs port {tuple(own[k].shape)}")
        self.load_state_dict({**own, **sd})

    # ---------------------------------------------------------------- utils

    def _cameras_all(self, batch):
        """One ``Camera`` per sample with (V_total,) leading dims."""
        H, W = batch["tar_rgb"].shape[2:4]
        return [
            Camera.from_c2w(batch["tar_c2w"][b], batch["fovx"][b],
                            batch["fovy"][b], width=W, height=H,
                            znear=batch["near_far"][b, 0],
                            zfar=batch["near_far"][b, 1])
            for b in range(batch["tar_rgb"].shape[0])
        ]

    def _render_views(self, cams, bgs, centers, shs, opacity_raw, scaling_raw,
                      rotation_raw, valid) -> dict:
        """Render one sample's views (``cams`` with (V,) leading dims) ->
        per-view outputs stacked over views."""
        cfg = self.cfg
        opacity = torch.sigmoid(opacity_raw.reshape(-1))
        opacity = torch.where(valid, opacity, torch.zeros_like(opacity))
        scales = torch.exp(scaling_raw)
        max_pairs = (int(centers.shape[0] * cfg.pair_budget)
                     if cfg.pair_budget > 0 else None)
        outs = [
            rasterize(centers, shs, opacity, scales, rotation_raw, cams[j],
                      bgs[j], cfg.sh_degree, tile_size=cfg.tile_size,
                      max_tiles=cfg.max_tiles, max_per_tile=cfg.max_per_tile,
                      max_pairs=max_pairs, enum_tiles=cfg.enum_tiles or None)
            for j in range(bgs.shape[0])
        ]
        return {k: torch.stack([getattr(o, k) for o in outs])
                for k in ("image", "alpha", "depth", "overflow")}

    # -------------------------------------------------------------- forward

    def forward(self, batch, with_fine: bool = False):
        if with_fine:
            raise NotImplementedError(
                "with_fine=True: gradient-guided selection, the densifier and "
                "the fine render arrive with ROADMAP slice 2")
        cfg = self.cfg
        B, V_total, H, W, _ = batch["tar_rgb"].shape
        V = cfg.n_views

        src = batch["tar_rgb"][:, :V].reshape(B * V, H, W, 3)
        tokens = self.img_encoder(src)                       # (B·V, L, C)
        token_hw = math.isqrt(tokens.shape[1])
        feat_hw = tokens.reshape(B * V, token_hw, token_hw, -1)

        # Plücker ray modulation
        rays_down = batch["tar_rays_down"][:, :V].reshape(
            B * V, *batch["tar_rays_down"].shape[2:])
        plucker = rays_to_plucker(rays_down)
        cond = torch.cat(
            [rsh_cart(plucker[..., :3], 3), rsh_cart(plucker[..., 3:6], 3)],
            dim=-1)
        feat_hw = self.dir_norm(feat_hw, cond)

        # lift to an R³ feature volume sampled from the token grid
        R = cfg.vol_feat_reso
        w2cs = batch["tar_w2c"][:, :V].reshape(B * V, 4, 4)
        ixts = batch["tar_ixt"][:, :V].reshape(B * V, 3, 3)
        xy, _ = project_points(self.volume_grid, w2cs, ixts)  # (B·V, R³, 2)
        img_wh = torch.tensor([W, H], dtype=torch.float32, device=xy.device)
        xy_norm = (xy + 0.5) / img_wh * 2.0 - 1.0
        feat_vol = bilinear_sample(feat_hw, xy_norm).reshape(B, V, R, R, R, -1)
        if self.view_embed is not None:
            ve = self.view_embed[:, :V].reshape(1, V, 1, 1, 1, cfg.view_embed_dim)
            feat_vol = torch.cat(
                [feat_vol, ve.expand(B, V, R, R, R, cfg.view_embed_dim)], dim=-1)

        volume_feat = self.vol_decoder(feat_vol)             # (B, (2R')³, 80)
        offset, shs_c, scaling_c, rotation_c, opacity_c = self.decoder.coarse(
            volume_feat, cfg.opacity_shift, cfg.scaling_shift)
        half_cell = 0.5 * cfg.scene_size / cfg.n_offset_groups
        base_centers = self.group_centers[:, None, :].expand(
            -1, cfg.K, 3).reshape(1, -1, 3)
        centers = base_centers + offset * half_cell            # (B, N, 3)
        N = centers.shape[1]
        all_valid = torch.ones((N,), dtype=torch.bool, device=centers.device)

        cams_all = self._cameras_all(batch)
        coarse = [
            self._render_views(cams_all[b], batch["bg_color"][b], centers[b],
                               shs_c[b], opacity_c[b], scaling_c[b],
                               rotation_c[b], all_valid)
            for b in range(B)
        ]
        stack = lambda name: torch.stack([c[name] for c in coarse])
        return {
            "image": _cat_views(stack("image")),
            "depth": _cat_views(stack("depth"))[..., None],
            "acc_map": _cat_views(stack("alpha")),
            "overflow": stack("overflow"),
            "render_pkg": [(centers, shs_c, opacity_c, scaling_c, rotation_c)],
        }


def _cat_views(x: torch.Tensor) -> torch.Tensor:
    """(B, V, H, W[, C]) -> (B, H, V*W[, C]) — the width-concat layout."""
    if x.dim() == 5:
        B, V, H, W, C = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(B, H, V * W, C)
    B, V, H, W = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, H, V * W)

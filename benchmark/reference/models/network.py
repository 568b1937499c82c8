"""The Generative Densification network, PyTorch: serving and training;
the benchmark's frozen copy of the port's ``models/network.py``.

Changed from the port: the network is built without drawing weights (the
benchmark fills them from its seed), and ``follow``, if set, is called with
the coarse primitives and with the fine union as this network computes
them, and returns what the network goes on with (the program's, when the
benchmark follows the program stage by stage).

Port of ``generativedensification_tpu/models/network.py``
``Network.__call__(batch, with_fine=..., deterministic=...)``:

  * coarse: DINO ViT tokens, Plücker-ray modulation, a feature volume
    lifted from the token maps, the group-attention volume transformer,
    the coarse Gaussian head on the (2R)³ grid, every view rendered through
    the 3DGS rasterizer (one forward compositor launch per view);
  * fine (``with_fine=True``): the AbsGS selection gradients of the source
    views (fused selection: the source views' coarse renders also give them,
    one ``selonly`` backward compositor launch per source view; or, with
    ``share_selection=False``, the isolated closure: ``torch.autograd.grad``
    through a second 3DGS render of the source views over zero
    ``screen_offset`` / ``screen_abs`` inputs), the static opacity pool,
    per-view point features and the fine head, top-k selection, the
    densification decoder stages, the union of the decoder leaves with the
    unselected pool remainder, and every view rendered again from that
    union.

Everything is differentiable through autograd (the compositors' backwards
are the backward kernels).  ``module.train()`` is the JAX
``deterministic=False``: the densifier's dropout, drop-path and order
shuffling draw from the ``generator`` given to ``forward``.  The ViT and
volume-transformer blocks are recomputed in the backward (``remat``, always
on, as in the JAX modules).

``renderer="2dgs"`` (``tpu.renderer``) sends every render, coarse and fine,
through the surfel rasterizer (``splat/surfel.py``: one surfel forward
launch per view, one ``selonly`` surfel backward per source view for the
fused selection) and adds the coarse ``rend_dist``, ``rend_normal`` and
``depth_normal`` maps; ``depth`` is then the 2DGS surface depth.

``compute_dtype="bfloat16"`` (``tpu.compute_dtype``, the config default) is
the JAX bf16 compute policy (``models/precision.py``): the ViT, the Plücker
modulation, the volume transformer's blocks and the densifier's blocks and
upscalers compute in bf16 over f32 parameters; the softmax and LayerNorm
statistics, the Gaussian heads, the rasterizer and its kernels and the loss
stay f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..core.camera import Camera
from ..core.rays import camera_rays, rays_to_plucker
from ..core.sh import rsh_cart
from ..points.modules import (
    Block,
    GaussianModule,
    MaskModule,
    MaskResModule,
    NeighborConvCPE,
    PDNorm,
    UpscaleModule,
    global_pooling,
    split_attributes,
)
from ..points.ops import topk_split
from ..points.structure import (
    PointSet,
    compute_neighbor_idx,
    gather_points,
    gather_rows,
    serialize_pointset,
)
from ..splat.rasterizer import rasterize
from ..splat.surfel import depth_to_normal, rasterize_surfels, surface_depth
from ..utils.device import resolve_device
from .backbone import (
    GaussianDecoder,
    ModLN,
    VolTransformer,
    bilinear_sample,
    build_dense_grid,
    project_points,
)
from .init import init_module_, lecun_normal_, normal_
from .precision import DTYPES, F32
from .vit import DinoEncoder


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Static hyperparameters (the JAX ``NetworkConfig`` fields; its TPU
    data-plane knobs — backend, vmap / remat of renders, the XLA chunk —
    have no meaning here: renders keep their few small residuals)."""

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
    # point decoder
    k_num: int = 12000
    order: tuple = ("z", "z-trans", "hilbert", "hilbert-trans")
    stride: tuple = (2,)
    dec_depths: tuple = (2, 2)
    dec_channels: tuple = (160, 256)
    dec_num_head: tuple = (20, 32)
    dec_patch_size: tuple = (48, 48)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    attn_drop: float = 0.0
    proj_drop: float = 0.0
    drop_path: float = 0.3
    pre_norm: bool = True
    shuffle_orders: bool = True
    enable_ada_lnnorm: bool = True
    upscale_factor: tuple = (2, 4)
    n_frequencies: int = 15
    enable_absolute_pe: bool = False
    enable_upscale_drop_path: bool = True
    use_mask: bool = True
    temperature: float = 1.0
    non_leaf_ratio: tuple = (0.8,)
    mask_sampling_type: str = "topk"
    enable_residual_attribute: bool = False
    pdnorm_ln: bool = False
    pdnorm_conditions: tuple = ("ScanNet", "S3DIS", "Structured3D")
    mask_pool: int = 49152        # static stand-in for the opacity mask
    share_selection: bool = True  # fused selection (False: isolated closure)
    # rasterizer static budgets
    tile_size: int = 32
    max_tiles: int = 4
    max_per_tile: int = 4096
    enum_tiles: int = 0
    pair_budget: float = 0.0
    scene_size: float = 0.5
    compute_dtype: str = "float32"
    renderer: str = "3dgs"        # 3dgs | 2dgs
    depth_ratio: float = 0.0      # 2DGS expected/median depth blend

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
            k_num=m.k_num,
            order=tuple(m.order),
            stride=tuple(m.stride),
            dec_depths=tuple(m.dec_depths),
            dec_channels=tuple(m.dec_channels),
            dec_num_head=tuple(m.dec_num_head),
            dec_patch_size=tuple(m.dec_patch_size),
            mlp_ratio=m.mlp_ratio,
            qkv_bias=m.qkv_bias,
            qk_scale=m.qk_scale,
            attn_drop=m.attn_drop,
            proj_drop=m.proj_drop,
            drop_path=m.drop_path,
            pre_norm=m.pre_norm,
            shuffle_orders=m.shuffle_orders,
            enable_ada_lnnorm=m.enable_ada_lnnorm,
            upscale_factor=tuple(m.upscale_factor),
            n_frequencies=m.n_frequencies,
            enable_absolute_pe=m.enable_absolute_pe,
            enable_upscale_drop_path=m.enable_upscale_drop_path,
            use_mask=m.use_mask,
            temperature=m.temperature,
            non_leaf_ratio=tuple(m.non_leaf_ratio),
            mask_sampling_type=m.mask_sampling_type,
            enable_residual_attribute=m.enable_residual_attribute,
            pdnorm_ln=get(m, "pdnorm_ln", cls.pdnorm_ln),
            pdnorm_conditions=tuple(
                get(m, "pdnorm_conditions", cls.pdnorm_conditions) or ()),
            mask_pool=get(m, "mask_pool", cls.mask_pool),
            share_selection=get(tpu, "share_selection", cls.share_selection),
            tile_size=get(tpu, "tile_size", cls.tile_size),
            max_tiles=get(tpu, "max_tiles", cls.max_tiles),
            max_per_tile=get(tpu, "max_per_tile", cls.max_per_tile),
            enum_tiles=get(tpu, "enum_tiles", cls.enum_tiles),
            pair_budget=get(tpu, "pair_budget", cls.pair_budget),
            compute_dtype=get(tpu, "compute_dtype", cls.compute_dtype),
            renderer=get(tpu, "renderer", cls.renderer),
            depth_ratio=get(tpu, "depth_ratio", cls.depth_ratio),
        )

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (bf16 for ``"bfloat16"``, else f32, as JAX)."""
        return DTYPES.get(self.compute_dtype, F32)

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

    @property
    def fine_scaling_shift(self) -> float:
        return math.log(0.5 * self.voxel_size / (8 * 3.0))

    @property
    def pdnorm_n(self) -> int:
        return len(self.pdnorm_conditions) if self.pdnorm_ln else 0

    def level_sizes(self) -> list[dict]:
        """Static per-level point counts of the densification decoder."""
        sizes = []
        n = self.k_num
        n_levels = len(self.dec_channels)
        for s in range(n_levels):
            up = n * self.upscale_factor[s]
            ratio = self.non_leaf_ratio[s] if s < n_levels - 1 else 1.0
            k = math.ceil(up * ratio) if ratio < 1.0 else up
            sizes.append(dict(level=s, in_pts=n, up_pts=up, non_leaf=k,
                              leaf=(up - k) if ratio < 1.0 else up))
            n = k
        return sizes


class DensifierStage(nn.Module):
    """One decoder level: [global pooling] -> serialize -> blocks ->
    upscale -> head / mask, returning (non_leaf, leaf)."""

    def __init__(self, cfg: NetworkConfig, stage: int):
        super().__init__()
        self.cfg, self.stage = cfg, stage
        s = stage
        self.last = s == len(cfg.dec_channels) - 1
        out_ch = cfg.dec_channels[s] if self.last else cfg.dec_channels[s + 1]
        ratio = 1.0 if (self.last or not cfg.use_mask) else cfg.non_leaf_ratio[s]
        C = cfg.dec_channels[s]
        # linearly spaced drop-path rates over all blocks, reversed
        total = sum(cfg.dec_depths)
        dpr = [cfg.drop_path * i / max(total - 1, 1) for i in range(total)][::-1]
        off = sum(cfg.dec_depths[:s])
        dpr_s = dpr[off: off + cfg.dec_depths[s]]
        self.blocks = nn.ModuleList(
            Block(C, cfg.dec_num_head[s], cfg.dec_patch_size[s], cfg.mlp_ratio,
                  cfg.qkv_bias, cfg.qk_scale, cfg.pre_norm,
                  order_index=i % len(cfg.order), pdnorm_n=cfg.pdnorm_n,
                  attn_drop=cfg.attn_drop, proj_drop=cfg.proj_drop,
                  drop_path=dpr_s[i], dtype=cfg.dtype)
            for i in range(cfg.dec_depths[s])
        )
        self.up = UpscaleModule(
            C, out_ch, cfg.upscale_factor[s], cfg.n_frequencies,
            cfg.enable_absolute_pe, carry_attribute=cfg.enable_residual_attribute,
            pdnorm_n=cfg.pdnorm_n,
            drop_path=dpr_s[-1] if cfg.enable_upscale_drop_path else 0.0,
            dtype=cfg.dtype)
        self.head = GaussianModule(out_ch, cfg.sh_degree)
        gate = MaskResModule if cfg.enable_residual_attribute else MaskModule
        self.mask = gate(out_ch, cfg.temperature, ratio, cfg.mask_sampling_type)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_module_(self, gen)
        for m in self.modules():
            if isinstance(m, NeighborConvCPE):
                lecun_normal_(m.weight, 27 * m.weight.shape[1], gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, PDNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, ps: PointSet, gen: torch.Generator | None = None):
        cfg, s = self.cfg, self.stage
        if s == 0 and cfg.enable_ada_lnnorm:
            ps = global_pooling(ps)
        shuffle = None
        if cfg.shuffle_orders and self.training:
            if gen is None:
                raise ValueError("order shuffling in training needs the step's "
                                 "torch.Generator (pass generator=...)")
            shuffle = torch.randperm(len(cfg.order), generator=gen,
                                     device=gen.device).to(ps.coord.device)
        ps = serialize_pointset(ps, cfg.order, shuffle=shuffle)
        ps = compute_neighbor_idx(ps)
        for block in self.blocks:
            ps = block(ps, gen)
        ps = self.up(ps, gen)

        if cfg.enable_residual_attribute:
            # head first, then mask
            attr = self.head(ps.feat)
            if ps.attribute is not None and s > 0:
                attr = attr + ps.attribute
            ps = ps.replace(attribute=attr)
            ps, split_idx, non_leaf_mask = self.mask(ps)
            if split_idx is None and non_leaf_mask is not None:
                non_leaf = ps.replace(mask=non_leaf_mask)
                leaf = ps.replace(mask=ps.mask & ~non_leaf_mask)
            elif split_idx is None:
                non_leaf, leaf = ps, ps
            else:
                top_idx, rest_idx = split_idx
                non_leaf = gather_points(
                    ps, top_idx, new_mask=torch.gather(non_leaf_mask, 1, top_idx))
                leaf = gather_points(
                    ps, rest_idx,
                    new_mask=torch.gather(~non_leaf_mask & ps.mask, 1, rest_idx))
        else:
            non_leaf, leaf = self.mask(ps)
            leaf = leaf.replace(attribute=self.head(leaf.feat))
        if not self.last:
            # the next level serializes at a finer grid
            non_leaf = non_leaf.replace(grid_size=non_leaf.grid_size / cfg.stride[s])
        return non_leaf, leaf


class Network(nn.Module):
    """Coarse + generative-densification network (``forward(batch,
    with_fine=...)``).

    ``device=None`` runs on the card (and raises without one); the CPU
    takes only an explicit ``device="cpu"``.  Its weights are left as the
    modules made them: the benchmark fills them (``seed`` is unused).  A new
    network is in evaluation mode (the JAX ``deterministic=True`` default);
    ``train()`` turns on dropout, drop-path and order shuffling.
    """

    def __init__(self, cfg: NetworkConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.img_encoder = DinoEncoder(cfg.encoder_backbone, cfg.dtype)
        C = self.img_encoder.num_features
        # two degree-3 rsh_cart blocks
        self.dir_norm = ModLN(C, 2 * 16, cfg.dtype)
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
            dtype=cfg.dtype,
        )
        self.decoder = GaussianDecoder(
            in_dim=cfg.vol_embedding_out_dim, sh_dim=cfg.sh_dim, K=cfg.K
        )
        self.stages = nn.ModuleList(
            DensifierStage(cfg, s) for s in range(len(cfg.dec_channels)))
        self.register_buffer(
            "volume_grid", build_dense_grid(cfg.vol_feat_reso, cfg.scene_size),
            persistent=False)
        self.register_buffer(
            "group_centers",
            build_dense_grid(cfg.vol_embedding_reso * 2, cfg.scene_size),
            persistent=False)
        self.follow = None
        self.to(dev)
        self.eval()

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.img_encoder.reset_parameters(gen)
        init_module_(self.dir_norm, gen)
        if self.view_embed is not None:
            normal_(self.view_embed, self.cfg.view_embed_dim ** -0.5, gen)
        self.vol_decoder.reset_parameters(gen)
        self.decoder.reset_parameters(gen)
        for stage in self.stages:
            stage.reset_parameters(gen)

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
                      rotation_raw, valid, sel_gt=None, screen=None) -> dict:
        """Render one sample's views (``cams`` with (V,) leading dims) ->
        per-view outputs stacked over views.

        ``sel_gt`` (V_s, H, W, 3): fused AbsGS selection — the first V_s
        views (the source views) also give ``sel_abs`` (V_s, N, 2) against
        their ground truth, from the same forward (no second render).
        ``screen`` (screen_offset, screen_abs): the rasterizer's gradient
        hooks; with them every renderer goes through the 3DGS rasterizer,
        whose backward gives the AbsGS channels (the JAX network does the
        same for the isolated selection closure)."""
        cfg = self.cfg
        opacity = torch.sigmoid(opacity_raw.reshape(-1))
        opacity = torch.where(valid, opacity, torch.zeros_like(opacity))
        scales = torch.exp(scaling_raw)
        max_pairs = (int(centers.shape[0] * cfg.pair_budget)
                     if cfg.pair_budget > 0 else None)
        n_sel = 0 if sel_gt is None else sel_gt.shape[0]
        if cfg.renderer == "2dgs" and screen is None:
            return self._render_views_2dgs(cams, bgs, centers, shs, opacity,
                                           scales, rotation_raw, sel_gt)
        screen_offset, screen_abs = (None, None) if screen is None else screen
        outs = [
            rasterize(centers, shs, opacity, scales, rotation_raw, cams[j],
                      bgs[j], cfg.sh_degree, tile_size=cfg.tile_size,
                      max_tiles=cfg.max_tiles, max_per_tile=cfg.max_per_tile,
                      max_pairs=max_pairs, enum_tiles=cfg.enum_tiles or None,
                      sel_gt=sel_gt[j] if j < n_sel else None,
                      screen_offset=screen_offset, screen_abs=screen_abs)
            for j in range(bgs.shape[0])
        ]
        res = {k: torch.stack([getattr(o, k) for o in outs])
               for k in ("image", "alpha", "depth", "overflow")}
        if n_sel:
            res["sel_abs"] = torch.stack([o.sel_abs for o in outs[:n_sel]])
        return res

    def _render_views_2dgs(self, cams, bgs, centers, shs, opacity, scales,
                           rotation_raw, sel_gt=None) -> dict:
        """Surfel rasterization of one sample's views and the 2DGS maps:
        the surface depth (expected depth / alpha blended with the median
        depth by ``depth_ratio``), the rendered normal rotated to world
        space, the depth-derived normal and the distortion."""
        cfg = self.cfg
        n_sel = 0 if sel_gt is None else sel_gt.shape[0]
        res = {k: [] for k in ("image", "alpha", "depth", "overflow", "dist",
                               "rend_normal", "depth_normal", "sel_abs")}
        for j in range(bgs.shape[0]):
            cam = cams[j]
            out = rasterize_surfels(
                centers, shs, opacity, scales[..., :2], rotation_raw, cam, bgs[j],
                cfg.sh_degree, tile_size=cfg.tile_size, max_tiles=cfg.max_tiles,
                max_per_tile=cfg.max_per_tile, enum_tiles=cfg.enum_tiles or None,
                sel_gt=sel_gt[j] if j < n_sel else None)
            surf_depth = surface_depth(out, cfg.depth_ratio)
            res["image"].append(out.image)
            res["alpha"].append(out.alpha)
            res["depth"].append(surf_depth)
            res["overflow"].append(out.overflow)
            res["dist"].append(out.dist)
            res["rend_normal"].append(out.normal @ cam.world_view_transform[:3, :3].T)
            res["depth_normal"].append(
                depth_to_normal(surf_depth, camera_rays(cam), out.alpha))
            if j < n_sel:
                res["sel_abs"].append(out.sel_abs)
        return {k: torch.stack(v) for k, v in res.items() if v}

    def _render_all(self, batch, cams_all, gs, valid, sel_gt=None) -> dict:
        """Every sample's views -> outputs stacked as (B, V_total, ...)."""
        centers, shs, opacity, scaling, rotation = gs
        per_b = [
            self._render_views(cams_all[b], batch["bg_color"][b], centers[b],
                               shs[b], opacity[b], scaling[b], rotation[b],
                               valid[b], None if sel_gt is None else sel_gt[b])
            for b in range(len(cams_all))
        ]
        return {k: torch.stack([r[k] for r in per_b]) for k in per_b[0]}

    # -------------------------------------------------------------- forward

    def _isolated_selection(self, batch, cams_all, gs, valid):
        """``share_selection=False``: the reference's selection closure.
        Each sample's source views are rendered again through the 3DGS
        rasterizer from detached attributes, and ``torch.autograd.grad`` of
        the image MSE over the V-view stack gives the AbsGS gradient of the
        zero ``screen_abs`` input (the backward kernel in ``full`` mode).
        Returns the (B, N) scores |dL/d screen_abs|, without gradient."""
        if torch.is_inference_mode_enabled():
            raise RuntimeError("share_selection=False differentiates a render: "
                               "run the forward under torch.no_grad(), not "
                               "torch.inference_mode()")
        V = self.cfg.n_views
        gt = batch["tar_rgb"][:, :V]
        scores = []
        for b in range(len(cams_all)):
            centers, shs, opa, scaling, rot = (g[b].detach() for g in gs)
            zeros = lambda: torch.zeros((centers.shape[0], 2), device=centers.device,
                                        requires_grad=True)
            screen = (zeros(), zeros())
            with torch.enable_grad():
                out = self._render_views(cams_all[b][:V], batch["bg_color"][b, :V],
                                         centers, shs, opa, scaling, rot, valid[b],
                                         screen=screen)
                loss = ((out["image"] - gt[b]) ** 2).mean()
                g_abs = torch.autograd.grad(loss, screen)[1]
            scores.append(torch.linalg.vector_norm(g_abs, dim=-1))
        return torch.stack(scores)

    def forward(self, batch, with_fine: bool = False,
                generator: torch.Generator | None = None):
        """The JAX ``Network.__call__``; ``self.training`` is its
        ``deterministic=False``, and the densifier's random draws come from
        ``generator`` (on the network's device)."""
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
        if self.follow is not None:
            centers, shs_c, opacity_c, scaling_c, rotation_c = self.follow(
                "coarse", (centers, shs_c, opacity_c, scaling_c, rotation_c))
        N = centers.shape[1]
        all_valid = torch.ones((B, N), dtype=torch.bool, device=centers.device)

        # coarse renders, all V_total views; with the fine stage and fused
        # selection the source views' renders also give the AbsGS selection
        # gradients (one selonly backward per source view, no re-render)
        cams_all = self._cameras_all(batch)
        gs_coarse = (centers, shs_c, opacity_c, scaling_c, rotation_c)
        share_sel = with_fine and cfg.share_selection
        coarse = self._render_all(batch, cams_all, gs_coarse, all_valid,
                                  batch["tar_rgb"][:, :V] if share_sel else None)
        outputs = {
            "image": _cat_views(coarse["image"]),
            "depth": _cat_views(coarse["depth"])[..., None],
            "acc_map": _cat_views(coarse["alpha"]),
            "overflow": coarse["overflow"],
        }
        if cfg.renderer == "2dgs":
            # the 2DGS maps of the coarse renders (the regularizers' inputs)
            outputs["rend_dist"] = _cat_views(coarse["dist"])
            outputs["rend_normal"] = _cat_views(coarse["rend_normal"])
            outputs["depth_normal"] = _cat_views(coarse["depth_normal"])
        render_pkg = [(centers, shs_c, opacity_c, scaling_c, rotation_c)]
        if not with_fine:
            outputs["render_pkg"] = render_pkg
            return outputs

        # ================= fine stage =================
        opacity_act = torch.sigmoid(opacity_c[..., 0])
        opacity_ok = opacity_act > 0.005                          # (B, N)
        if share_sel:
            # per-view abs grads sum across views; each view's cotangent is
            # the per-view MSE's, while the reference differentiates one mean
            # over the V-view concat: divide by V so the scores match it
            sel_score = torch.linalg.vector_norm(coarse["sel_abs"].sum(1),
                                                 dim=-1) / V
        else:
            sel_score = self._isolated_selection(batch, cams_all, gs_coarse,
                                                 all_valid)

        pool_idx = static_opacity_pool(opacity_act, cfg.mask_pool)
        M = pool_idx.shape[1]
        take2 = lambda a: gather_rows(a, pool_idx)
        take1 = lambda a: torch.gather(a, 1, pool_idx)
        pool_valid = take1(opacity_ok)
        pool_centers = take2(centers)
        pool_score = torch.where(pool_valid, take1(sel_score),
                                 torch.full_like(pool_centers[..., 0], -1.0))

        # per-view point features + fine head
        point_feats = torch.stack([
            self._point_feats(batch["tar_w2c"][b, :V], batch["tar_ixt"][b, :V],
                              batch["tar_rgb"][b, :V], pool_centers[b],
                              coarse["image"][b, :V], coarse["alpha"][b, :V],
                              coarse["depth"][b, :V])
            for b in range(B)
        ])                                            # (B, M, V, 8)
        pool_vol_feat = take2(volume_feat)            # (B, M, 80)
        fine_feat, sh_res = self.decoder.fine(pool_vol_feat, point_feats)
        pool_shs = take2(shs_c.reshape(B, N, -1)).reshape(B, M, -1, 3)
        fine_shs = sh_res.reshape(B, M, -1, 3) + pool_shs
        features160 = torch.cat([fine_feat, pool_vol_feat], dim=-1)

        # split the pool into selected (to the densifier) and remainder
        sel_idx, rest_idx, sel_ok, rest_ok = topk_split(pool_score, pool_valid,
                                                        cfg.k_num)
        tsel2 = lambda a: gather_rows(a, sel_idx)
        trest2 = lambda a: gather_rows(a, rest_idx)
        sel_centers = tsel2(pool_centers)
        sel_feats = tsel2(features160)
        if cfg.enable_residual_attribute:
            ps = PointSet(coord=sel_centers * 2.0, feat=sel_feats, mask=sel_ok,
                          grid_size=cfg.voxel_size)
        else:
            ps = PointSet(coord=sel_centers, feat=sel_feats, mask=sel_ok,
                          grid_size=0.5 * cfg.voxel_size)

        # densification decoder levels
        leaves = []
        for stage in self.stages:
            ps, leaf = stage(ps, generator)
            leaves.append(leaf)

        # union of the decoder leaves
        xyz_u, sh_u, op_u, sc_u, rot_u, ok_u = [], [], [], [], [], []
        for leaf in leaves:
            sh, op, sc, rot = split_attributes(leaf.attribute, cfg.sh_degree)
            xyz_u.append(leaf.coord / 2.0 if cfg.enable_residual_attribute
                         else leaf.coord)
            sh_u.append(sh)
            op_u.append(op + cfg.opacity_shift)
            sc_u.append(sc + cfg.fine_scaling_shift)
            rot_u.append(rot)
            ok_u.append(leaf.mask)

        # the unselected pool remainder keeps coarse attributes + fine SH
        xyz_u.append(trest2(pool_centers))
        sh_u.append(trest2(fine_shs.reshape(B, M, -1)))
        op_u.append(trest2(take2(opacity_c)))
        sc_u.append(trest2(take2(scaling_c)))
        rot_u.append(trest2(take2(rotation_c)))
        ok_u.append(rest_ok)

        fine_centers = torch.cat(xyz_u, dim=1)
        fine_sh = torch.cat([s.reshape(B, s.shape[1], -1) for s in sh_u], dim=1)
        fine_op = torch.cat(op_u, dim=1)
        fine_sc = torch.cat(sc_u, dim=1)
        fine_rot = torch.cat(rot_u, dim=1)
        fine_ok = torch.cat(ok_u, dim=1)
        if self.follow is not None:
            fine_centers, fine_sh, fine_op, fine_sc, fine_rot, fine_ok = self.follow(
                "fine", (fine_centers, fine_sh, fine_op, fine_sc, fine_rot, fine_ok))
        fine = self._render_all(
            batch, cams_all,
            (fine_centers, fine_sh.reshape(B, fine_sh.shape[1], -1, 3), fine_op,
             fine_sc, fine_rot), fine_ok)

        outputs.update({
            "image_fine": _cat_views(fine["image"]),
            "depth_fine": _cat_views(fine["depth"])[..., None],
            "acc_map_fine": _cat_views(fine["alpha"]),
        })
        # the fine renders (the largest point set, the likeliest to hit a
        # static budget) feed the overflow diagnostic too
        outputs["overflow"] = outputs["overflow"] + fine["overflow"]
        render_pkg.append((fine_centers, fine_sh, fine_op, fine_sc, fine_rot, fine_ok))
        outputs["render_pkg"] = render_pkg
        return outputs

    def _point_feats(self, w2cs, ixts, src, points, imgs, accs, depths):
        """8-channel per-view point features of one sample: [src RGB (3),
        render RGB (3), acc (1), |render_depth - point_z| (1)] -> (M, V, 8)."""
        H, W = imgs.shape[1:3]
        xy, z = project_points(points, w2cs, ixts)     # (V, M, 2), (V, M, 1)
        img_wh = torch.tensor([W, H], dtype=torch.float32, device=xy.device)
        xy_norm = (xy + 0.5) / img_wh * 2.0 - 1.0
        stacked = torch.cat([src, imgs, accs[..., None], depths[..., None]], dim=-1)
        sampled = bilinear_sample(stacked, xy_norm)    # (V, M, 8)
        z_diff = (sampled[..., 7:8] - z).abs()
        return torch.cat([sampled[..., :7], z_diff], dim=-1).permute(1, 0, 2)


def static_opacity_pool(opacity_act: torch.Tensor, mask_pool: int) -> torch.Tensor:
    """(B, M) indices of the top ``min(mask_pool, N)`` points by activated
    opacity (the static stand-in for the reference's dynamic opacity mask;
    the union re-applies the 0.005 validity per pooled point).
    ``mask_pool >= N`` is the identity — the evaluation config sets pool =
    n_voxels for exact inference."""
    B, N = opacity_act.shape
    M = min(mask_pool, N)
    if M == N:
        return torch.arange(N, device=opacity_act.device).expand(B, N)
    return topk_split(opacity_act.detach(),
                      torch.ones_like(opacity_act, dtype=torch.bool), M)[0]


def _cat_views(x: torch.Tensor) -> torch.Tensor:
    """(B, V, H, W[, C]) -> (B, H, V*W[, C]) — the width-concat layout."""
    if x.dim() == 5:
        B, V, H, W, C = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(B, H, V * W, C)
    B, V, H, W = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, H, V * W)

"""The reference's checkpoints -> the port's ``Network``, PyTorch.

Port of ``generativedensification_tpu/utils/torch_convert.py``: maps a
reference Lightning checkpoint (``epoch=49.ckpt``, ``epoch=49_residual.ckpt``:
a torch ``state_dict`` with ``net.*`` keys) onto the port's
``Network.state_dict()`` names.

The reference is PyTorch and so is the port, so Linear, LayerNorm,
Conv2d, Conv3d and ConvTranspose3d weights load in the reference's own
layout: no transpose, no spatial flip.  The map changes a tensor only where
the port's parameter differs from the reference's, one line each in
``convert_state_dict``:

  * the ViT's packed ``attn.qkv`` (3C, C) / (3C,) is split into the port's
    ``attn.query`` / ``attn.key`` / ``attn.value`` rows;
  * the view embedding (1, 4, C, 1, 1, 1) is stored as (1, 4, 1, C), and
    the volume transformer's positional embedding (1, C, D, H, W) as
    (1, D, H, W, C) (the port keeps the JAX package's channel-last layout);
  * the CPE's submanifold-conv kernel (spconv's (O, 3, 3, 3, I), or
    (3, 3, 3, I, O), or torch-conv (O, I, 3, 3, 3)) is stored as
    (27, I, O) with the taps in (dz, dy, dx) order, the port's contraction
    layout.

``convert_state_dict`` reports, as the JAX converter does, how many
parameters it filled and which source keys it did not consume (the
reference's non-parameter buffers are expected there), and also which of
the port's parameters it left unfilled.  ``synthesize_reference_state_dict``
is a seeded state dict with the reference's exact key names and shapes
(a copy of the JAX package's), for tests and ``chip_smoke.py``: no
reference checkpoint is in the repository.
"""

from __future__ import annotations

import numpy as np
import torch


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint (``ckpt["state_dict"]``, or
    the file itself when it is a bare state dict), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().cpu() for k, v in sd.items() if hasattr(v, "detach")}


def synthesize_reference_state_dict(cfg, seed: int = 0) -> dict[str, np.ndarray]:
    """Random state_dict with the reference checkpoint's exact key names and
    shapes for a given :class:`NetworkConfig` (normal, std 0.02, f32)."""
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}

    def add(name, *shape):
        sd[name] = rng.normal(scale=0.02, size=shape).astype(np.float32)

    # ---- ViT (timm vit_base / our tiny_test stub share the layout)
    if "tiny_test" in cfg.encoder_backbone:
        C, depth, heads = 32, 1, 2
    elif "vit_small" in cfg.encoder_backbone:
        C, depth, heads = 384, 12, 6
    else:
        C, depth, heads = 768, 12, 12
    vp = "net.img_encoder.model."
    add(vp + "cls_token", 1, 1, C)
    add(vp + "pos_embed", 1, 14 * 14 + 1, C)
    add(vp + "patch_embed.proj.weight", C, 3, 16, 16)
    add(vp + "patch_embed.proj.bias", C)
    for i in range(depth):
        bp = vp + f"blocks.{i}."
        add(bp + "norm1.weight", C); add(bp + "norm1.bias", C)
        add(bp + "attn.qkv.weight", 3 * C, C); add(bp + "attn.qkv.bias", 3 * C)
        add(bp + "attn.proj.weight", C, C); add(bp + "attn.proj.bias", C)
        add(bp + "norm2.weight", C); add(bp + "norm2.bias", C)
        add(bp + "mlp.fc1.weight", 4 * C, C); add(bp + "mlp.fc1.bias", 4 * C)
        add(bp + "mlp.fc2.weight", C, 4 * C); add(bp + "mlp.fc2.bias", C)
    add(vp + "norm.weight", C); add(vp + "norm.bias", C)

    # ---- ModLN + view embedding
    add("net.dir_norm.norm.weight", C); add("net.dir_norm.norm.bias", C)
    add("net.dir_norm.mlp.1.weight", 2 * C, 32)
    add("net.dir_norm.mlp.1.bias", 2 * C)
    if cfg.view_embed_dim > 0:
        add("net.view_embed", 1, 4, cfg.view_embed_dim, 1, 1, 1)

    # ---- VolTransformer
    E = cfg.embedding_dim
    cond = C + cfg.view_embed_dim
    R = cfg.vol_embedding_reso
    add("net.vol_decoder.pos_embed", 1, E, R, R, R)
    for i in range(cfg.num_layers):
        bp = f"net.vol_decoder.layers.{i}."
        for n in ("norm1", "norm2", "norm3"):
            add(bp + n + ".weight", E); add(bp + n + ".bias", E)
        add(bp + "cross_attn.q_proj_weight", E, E)
        add(bp + "cross_attn.k_proj_weight", E, cond)
        add(bp + "cross_attn.v_proj_weight", E, cond)
        add(bp + "cross_attn.out_proj.weight", E, E)
        add(bp + "cnn.weight", E, E, 3, 3, 3)
        add(bp + "mlp.0.weight", 2 * E, E); add(bp + "mlp.0.bias", 2 * E)
        add(bp + "mlp.3.weight", E, 2 * E); add(bp + "mlp.3.bias", E)
    add("net.vol_decoder.norm.weight", E); add("net.vol_decoder.norm.bias", E)
    out_dim = cfg.vol_embedding_out_dim
    add("net.vol_decoder.deconv.weight", E, out_dim, 2, 2, 2)
    add("net.vol_decoder.deconv.bias", out_dim)

    # ---- GaussianDecoder
    D_in = out_dim
    gauss_out = 3 + cfg.sh_dim + 1 + 3 + 4
    add("net.decoder.mlp_coarse.0.weight", D_in, D_in)
    add("net.decoder.mlp_coarse.0.bias", D_in)
    add("net.decoder.mlp_coarse.2.weight", D_in, D_in)
    add("net.decoder.mlp_coarse.2.bias", D_in)
    add("net.decoder.mlp_coarse.4.weight", gauss_out * cfg.K, D_in)
    add("net.decoder.mlp_coarse.4.bias", gauss_out * cfg.K)
    add("net.decoder.norm.weight", D_in); add("net.decoder.norm.bias", D_in)
    add("net.decoder.cross_att.q_proj_weight", D_in, D_in)
    add("net.decoder.cross_att.k_proj_weight", D_in, 8)
    add("net.decoder.cross_att.v_proj_weight", D_in, 8)
    add("net.decoder.cross_att.out_proj.weight", D_in, D_in)
    add("net.decoder.mlp_fine.0.weight", D_in, D_in)
    add("net.decoder.mlp_fine.0.bias", D_in)
    add("net.decoder.mlp_fine.2.weight", D_in + cfg.sh_dim, D_in)
    add("net.decoder.mlp_fine.2.bias", D_in + cfg.sh_dim)

    # ---- densification decoder
    n_levels = len(cfg.dec_channels)
    num_attrs = 3 * (cfg.sh_degree + 1) ** 2 + 1 + 3 + 4
    for s in range(n_levels):
        sp = f"net.dec.{s}."
        Cs = cfg.dec_channels[s]
        Co = cfg.dec_channels[s + 1] if s < n_levels - 1 else cfg.dec_channels[s]
        for b in range(cfg.dec_depths[s]):
            bp = sp + f"block{b}."
            add(bp + "cpe.0.weight", Cs, 3, 3, 3, Cs)   # spconv v2 (O,k,k,k,I)
            add(bp + "cpe.0.bias", Cs)
            add(bp + "cpe.1.weight", Cs, Cs); add(bp + "cpe.1.bias", Cs)
            add(bp + "attn.qkv.weight", 3 * Cs, Cs)
            add(bp + "attn.qkv.bias", 3 * Cs)
            add(bp + "attn.proj.weight", Cs, Cs); add(bp + "attn.proj.bias", Cs)
            hid = int(Cs * cfg.mlp_ratio)
            add(bp + "mlp.0.fc1.weight", hid, Cs); add(bp + "mlp.0.fc1.bias", hid)
            add(bp + "mlp.0.fc2.weight", Cs, hid); add(bp + "mlp.0.fc2.bias", Cs)
        S = cfg.upscale_factor[s]
        pe_dim = 2 * 3 * cfg.n_frequencies if cfg.n_frequencies > 0 else 3
        add(sp + "up.delta_x.0.weight", Cs, Cs); add(sp + "up.delta_x.0.bias", Cs)
        add(sp + "up.delta_x.2.weight", 3 * S, Cs); add(sp + "up.delta_x.2.bias", 3 * S)
        add(sp + "up.skip.weight", Co, Cs); add(sp + "up.skip.bias", Co)
        add(sp + "up.delta_f.1.weight", Cs, pe_dim + Cs)
        add(sp + "up.delta_f.1.bias", Cs)
        add(sp + "up.delta_f.3.weight", Co, Cs); add(sp + "up.delta_f.3.bias", Co)
        ratio = cfg.non_leaf_ratio[s] if s < n_levels - 1 else 1.0
        if ratio < 1.0:
            add(sp + "mask.net.0.weight", Co, Co); add(sp + "mask.net.0.bias", Co)
            add(sp + "mask.net.2.weight", 1, Co); add(sp + "mask.net.2.bias", 1)
        add(sp + "head.feat2attr.0.weight", Co, Co)
        add(sp + "head.feat2attr.0.bias", Co)
        add(sp + "head.feat2attr.2.weight", num_attrs, Co)
        add(sp + "head.feat2attr.2.bias", num_attrs)
    return sd


def _cpe_kernel(w: np.ndarray) -> np.ndarray:
    """A submanifold-conv kernel in any of the reference's layouts ->
    (27, I, O), taps in the (dz, dy, dx) order of ``compute_neighbor_idx``."""
    if w.shape[0] == w.shape[1] == w.shape[2] == 3:       # (kD, kH, kW, I, O)
        return w.reshape(27, w.shape[3], w.shape[4])
    if w.shape[1] == w.shape[2] == w.shape[3] == 3:       # spconv (O, k, k, k, I)
        return np.transpose(w, (1, 2, 3, 4, 0)).reshape(27, w.shape[4], w.shape[0])
    return np.transpose(w, (2, 3, 4, 1, 0)).reshape(27, w.shape[1], w.shape[0])


# non-parameter buffers the reference registers (frequencies, grids) are
# expected to stay unconsumed
_EXPECTED_UNUSED = ("frequencies", "volume_grid", "group_centers", "grid")


def convert_state_dict(sd, net: torch.nn.Module, report: dict | None = None
                       ) -> dict[str, torch.Tensor]:
    """The reference state dict ``sd`` (numpy arrays or tensors) as a full
    ``state_dict`` of ``net``: every mapped tensor installed (in the target's
    dtype and device), every other entry ``net``'s own.  Prints the report;
    ``report``, if given, receives ``filled`` (port names), ``unconsumed``
    (source keys, the expected buffers excluded) and ``unfilled`` (port
    names)."""
    src = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
           for k, v in sd.items()}
    target = net.state_dict()
    out = dict(target)
    used: set = set()
    filled: list = []

    def get(k):
        used.add(k)
        return src[k]

    def put(name, value):
        if name not in target:
            raise KeyError(f"target parameter missing: {name}")
        t = target[name]
        if tuple(t.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: target {tuple(t.shape)} "
                             f"vs reference {tuple(value.shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value)).to(t.dtype).to(t.device)
        filled.append(name)

    def lin(s, d):          # Linear / LayerNorm / conv: weight and bias as stored
        if s + ".weight" in src:
            put(d + ".weight", get(s + ".weight"))
            if s + ".bias" in src:
                put(d + ".bias", get(s + ".bias"))

    # ViT
    vp, tp = "net.img_encoder.model.", "img_encoder.vit."
    if any(k.startswith(vp + "blocks.") for k in src):
        depth = 1 + max(int(k.split(".")[4]) for k in src if k.startswith(vp + "blocks."))
        for k in ("cls_token", "pos_embed"):
            put(tp + k, get(vp + k))
        lin(vp + "patch_embed.proj", tp + "patch_embed")    # Conv2d as stored
        for i in range(depth):
            s, d = f"{vp}blocks.{i}.", f"{tp}blocks.{i}."
            lin(s + "norm1", d + "norm1")
            lin(s + "norm2", d + "norm2")
            qkv_w = get(s + "attn.qkv.weight")
            qkv_b = get(s + "attn.qkv.bias") if s + "attn.qkv.bias" in src else None
            C = qkv_w.shape[0] // 3
            for j, name in enumerate(("query", "key", "value")):   # qkv split
                put(f"{d}attn.{name}.weight", qkv_w[j * C:(j + 1) * C])
                if qkv_b is not None:
                    put(f"{d}attn.{name}.bias", qkv_b[j * C:(j + 1) * C])
            lin(s + "attn.proj", d + "attn.out")
            lin(s + "mlp.fc1", d + "mlp_fc1")
            lin(s + "mlp.fc2", d + "mlp_fc2")
        lin(vp + "norm", tp + "norm")

    # ModLN and the view embedding
    lin("net.dir_norm.mlp.1", "dir_norm.mlp")
    lin("net.dir_norm.norm", "dir_norm.norm")
    if "net.view_embed" in src:                          # (1, 4, C, 1, 1, 1)
        put("view_embed", get("net.view_embed").reshape(1, 4, 1, -1))

    # VolTransformer
    if "net.vol_decoder.pos_embed" in src:               # (1, C, D, H, W)
        put("vol_decoder.pos_embed",
            np.transpose(get("net.vol_decoder.pos_embed"), (0, 2, 3, 4, 1)))
    layers = {k.split(".")[3] for k in src if k.startswith("net.vol_decoder.layers.")}
    for i in range(len(layers)):
        s, d = f"net.vol_decoder.layers.{i}.", f"vol_decoder.layers.{i}."
        for n in ("norm1", "norm2", "norm3"):
            lin(s + n, d + n)
        if s + "cross_attn.q_proj_weight" in src:
            for a in ("q", "k", "v"):
                put(f"{d}cross_attn.{a}.weight", get(f"{s}cross_attn.{a}_proj_weight"))
            put(d + "cross_attn.out.weight", get(s + "cross_attn.out_proj.weight"))
        if s + "cnn.weight" in src:                      # Conv3d as stored
            put(d + "cnn.weight", get(s + "cnn.weight"))
        lin(s + "mlp.0", d + "mlp_fc1")
        lin(s + "mlp.3", d + "mlp_fc2")
    lin("net.vol_decoder.norm", "vol_decoder.norm")
    lin("net.vol_decoder.deconv", "vol_decoder.deconv")  # ConvTranspose3d as stored

    # GaussianDecoder
    lin("net.decoder.mlp_coarse.0", "decoder.coarse_fc0")
    lin("net.decoder.mlp_coarse.2", "decoder.coarse_fc1")
    lin("net.decoder.mlp_coarse.4", "decoder.coarse_out")
    lin("net.decoder.norm", "decoder.fine_norm")
    if "net.decoder.cross_att.q_proj_weight" in src:
        for a in ("q", "k", "v"):
            put(f"decoder.fine_cross.{a}.weight",
                get(f"net.decoder.cross_att.{a}_proj_weight"))
        put("decoder.fine_cross.out.weight", get("net.decoder.cross_att.out_proj.weight"))
    lin("net.decoder.mlp_fine.0", "decoder.fine_fc0")
    lin("net.decoder.mlp_fine.2", "decoder.fine_out")

    # densification decoder stages
    stages = {k.split(".")[2] for k in src if k.startswith("net.dec.")}
    for st in range(len(stages)):
        s, d = f"net.dec.{st}.", f"stages.{st}."
        blocks = {k.split(".")[3] for k in src
                  if k.startswith(s + "block") and k.endswith("attn.qkv.weight")}
        for b in range(len(blocks)):
            bs, bd = f"{s}block{b}.", f"{d}blocks.{b}."
            lin(bs + "cpe.1", bd + "cpe.linear")
            if bs + "cpe.0.weight" in src:
                put(bd + "cpe.weight", _cpe_kernel(get(bs + "cpe.0.weight")))
            if bs + "cpe.0.bias" in src:
                put(bd + "cpe.bias", get(bs + "cpe.0.bias"))
            lin(bs + "attn.qkv", bd + "attn.qkv")
            lin(bs + "attn.proj", bd + "attn.proj")
            lin(bs + "mlp.0.fc1", bd + "mlp.fc1")
            lin(bs + "mlp.0.fc2", bd + "mlp.fc2")
        lin(s + "up.delta_x.0", d + "up.delta_x_fc1")
        lin(s + "up.delta_x.2", d + "up.delta_x_fc2")
        lin(s + "up.skip", d + "up.skip")
        lin(s + "up.delta_f.1", d + "up.delta_f_fc1")
        lin(s + "up.delta_f.3", d + "up.delta_f_fc2")
        lin(s + "mask.net.0", d + "mask.net_fc1")
        lin(s + "mask.net.2", d + "mask.net_fc2")
        lin(s + "head.feat2attr.0", d + "head.feat2attr_fc1")
        lin(s + "head.feat2attr.2", d + "head.feat2attr_fc2")

    unconsumed = [k for k in src if k not in used
                  and not any(t in k for t in _EXPECTED_UNUSED)]
    unfilled = [k for k in target if k not in set(filled)]
    print(f"[torch_convert] filled {len(filled)} of {len(target)} parameters")
    if unconsumed:
        print(f"[torch_convert] note: {len(unconsumed)} source keys not consumed "
              f"(first: {unconsumed[:5]})")
    if unfilled:
        print(f"[torch_convert] note: {len(unfilled)} parameters not filled "
              f"(first: {unfilled[:5]})")
    if report is not None:
        report.update(filled=filled, unconsumed=unconsumed, unfilled=unfilled)
    return out


def load_torch_network_params(path: str, net: torch.nn.Module,
                              report: dict | None = None) -> dict[str, torch.Tensor]:
    """A reference checkpoint file as a full ``state_dict`` of ``net``
    (see :func:`convert_state_dict`)."""
    return convert_state_dict(load_torch_state_dict(path), net, report)

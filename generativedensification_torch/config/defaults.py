"""Default configuration trees.

Copy of ``generativedensification_tpu/config/defaults.py`` (the port keeps
the same schema, ``tpu`` group included, so one config file drives both).

Schema mirrors the reference's ``configs/base.yaml`` / ``configs/infer.yaml``
key-for-key (so reference configs load unchanged), plus a ``tpu`` group for
mesh / precision / kernel-backend knobs that have no GPU counterpart.
``gpu_id`` is accepted for compatibility and interpreted as the
data-parallel mesh size.
"""

from __future__ import annotations

from .confignode import ConfigNode, from_dotlist, load_yaml, merge

BASE = {
    "gpu_id": [0, 1, 2, 3],  # compat: len() => data-parallel devices
    "exp_name": "Generative-Densification/tpu",
    "n_views": 4,
    "model": {
        "encoder_backbone": "vit_base_patch16_224.dino",
        "n_groups": [16],
        "n_offset_groups": 32,
        "K": 1,
        "sh_degree": 1,
        "num_layers": 12,
        "num_heads": 16,
        "view_embed_dim": 32,
        "embedding_dim": 256,
        "vol_feat_reso": 16,
        "vol_embedding_reso": 32,
        "vol_embedding_out_dim": 80,
        "ckpt_path": None,
        # point decoder
        "k_num": 12000,
        "order": ["z", "z-trans", "hilbert", "hilbert-trans"],
        "stride": [2],
        "dec_depths": [2, 2],
        "dec_channels": [160, 256],
        "dec_num_head": [20, 32],
        "dec_patch_size": [48, 48],
        "mlp_ratio": 4,
        "qkv_bias": True,
        "qk_scale": None,
        "attn_drop": 0.0,
        "proj_drop": 0.0,
        "drop_path": 0.3,
        "pre_norm": True,
        "shuffle_orders": True,
        "enable_rpe": False,
        "enable_flash": True,  # on TPU: fused windowed attention path
        "upcast_attention": False,
        "upcast_softmax": False,
        "pdnorm_bn": False,
        "pdnorm_ln": False,
        "pdnorm_decouple": True,
        "pdnorm_adaptive": False,
        "pdnorm_affine": True,
        "pdnorm_conditions": ["ScanNet", "S3DIS", "Structured3D"],
        "bnnorm_affine": False,
        "lnnorm_affine": False,
        "enable_ada_lnnorm": True,
        "upscale_factor": [2, 4],
        "n_frequencies": 15,
        "enable_absolute_pe": False,
        "enable_upscale_drop_path": True,
        "use_mask": True,
        "temperature": 1.0,
        "non_leaf_ratio": [0.8],
        "mask_sampling_type": "topk",
        "enable_residual_attribute": False,
        # TPU static stand-in for the reference's dynamic opacity mask
        # (network.py:804-805 `sigmoid(op) > 0.005` + _check_mask random
        # thinning :725-732): the fine stage keeps the top `mask_pool`
        # points by opacity.  Training default 49152 bounds memory like
        # the reference's random-50% thinning bounds it; set to n_voxels
        # (262144 at 64^3) for the EXACT mask semantics — evaluation.py
        # does this automatically (see INFER below).
        "mask_pool": 49152,
    },
    "train_dataset": {
        "dataset_name": "gobjeverse",
        "data_root": "dataset/gobjaverse/gobjaverse.h5",
        "split": "train",
        "img_size": [512, 512],
        "n_group": "${n_views}",
        "n_scenes": 3000000,
        "load_normal": True,
    },
    "test_dataset": {
        "dataset_name": "gobjeverse",
        "data_root": "dataset/gobjaverse/gobjaverse.h5",
        "split": "test",
        "img_size": [512, 512],
        "n_group": "${n_views}",
        "n_scenes": 3000000,
        "load_normal": True,
    },
    "train": {
        "batch_size": 3,
        "lr": 4e-4,
        "beta1": 0.9,
        "beta2": 0.95,
        "weight_decay": 0.05,
        "warmup_iters": 1000,
        "n_epoch": 30,
        "limit_train_batches": 0.2,
        "limit_val_batches": 0.02,
        "check_val_every_n_epoch": 1,
        "ckpt_every_n_epoch": 2,
        "start_fine": -1,
        "use_rand_views": False,
        "accumulate_grad_batches": 2,
        "gradient_clip_val": 0.5,
    },
    "test": {"batch_size": 3},
    "logger": {"name": "tensorboard", "dir": "./log"},
    # -- TPU-native group (no reference counterpart) -------------------------
    "tpu": {
        "mesh": {"data": -1},       # -1: all devices on the data axis
        "param_dtype": "float32",   # master weights (fixed; AMP-style policy)
        "compute_dtype": "bfloat16",
        "rasterizer_backend": "auto",  # auto | pallas | xla (jnp reference)
        "renderer": "3dgs",            # 3dgs | 2dgs
        "depth_ratio": 0.0,            # 2DGS expected/median depth blend
        "tile_size": 32,
        "max_tiles": 4,                # slot budget per Gaussian
        "max_per_tile": 4096,
        "enum_tiles": 0,               # >max_tiles: cull+compact window
        "raster_chunk": 32,
        "vmap_renders": False,         # vmap-over-B renders (CPU mesh/tests)
        "remat": True,
        "seed": 0,
        "profile_dir": None,
        "nan_check": False,
        # overflow-free warmup (train/train.py): generous budgets for the
        # first N steps so RANDOM-INIT splats bin without drops (the tight
        # budgets above are sized for trained voxel-scale primitives);
        # then the tight config.  Alarm fires when stats["overflow"] > 0
        # at the logging cadence: "warn" | "raise" | "off".
        "overflow_warmup_steps": 2000,
        # None = renderer-aware auto (3dgs: 9/16/8192, 2dgs: 16/25/16384
        # — the measured overflow==0-from-random-init budgets)
        "warmup_max_tiles": None,
        "warmup_enum_tiles": None,
        "warmup_max_per_tile": None,
        "overflow_alarm": "warn",
    },
}

INFER = {
    "n_views": 4,
    # eval-exact opacity mask: pool = n_voxels (64^3), so the fine union
    # is provably the reference's unbounded `sigmoid(op) > 0.005` set
    # (network.py:804-805 — no _check_mask thinning at eval)
    "model": {"mask_pool": 262144},
    "infer": {
        "dataset": {
            "dataset_name": "GSO",
            "data_root": "dataset/google_scanned_objects",
            "split": "test",
            "img_size": [512, 512],
            "n_group": 4,
            "n_scenes": 30000,
            "num_workers": 0,
            "batch_size": 1,
            "load_normal": False,
        },
        "ckpt_path": None,
        "eval_novel_view_only": True,
        "eval_depth": [],
        "metric_path": "None",
        "save_folder": "outputs/eval",
        "video_frames": 0,
        "mesh_video_frames": 0,
        "save_mesh": False,
        "aabb": [-0.5, -0.5, -0.5, 0.5, 0.5, 0.5],
        "finetuning": {
            "with_ft": False,
            "steps": 500,
            "position_lr": 0.000016,
            "feature_lr": 0.0025,
            "opacity_lr": 0.05,
            "scaling_lr": 0.005,
            "rotation_lr": 0.001,
        },
    },
}


def default_config() -> ConfigNode:
    return ConfigNode(BASE)


def default_infer_config() -> ConfigNode:
    return merge(ConfigNode(BASE), ConfigNode(INFER))


def load_config(yaml_paths: list[str] | None = None, overrides: list[str] | None = None,
                infer: bool = False) -> ConfigNode:
    """base defaults -> yaml files (in order) -> dotted CLI overrides."""
    nodes = [default_infer_config() if infer else default_config()]
    for p in yaml_paths or []:
        nodes.append(load_yaml(p))
    if overrides:
        nodes.append(from_dotlist(overrides))
    return merge(*nodes)

"""Dataset registry + batch-dict contract helpers."""

from __future__ import annotations

from typing import Callable, Dict

dataset_dict: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        dataset_dict[name] = cls
        return cls

    return deco


# The canonical per-sample dict (reference dataLoader/gobjverse.py:77-104):
#   fovx, fovy           scalars (radians)
#   tar_c2w, tar_w2c     (V, 4, 4) aligned poses (view 0 at (0,0,-r))
#   tar_ixt              (V, 3, 3)
#   tar_rgb              (V, H, W, 3) float32 in [0, 1], bg-composited
#   tar_msk              (V, H, W) uint8 alpha mask
#   bg_color             (V, 3)
#   transform_mats       (1, 4, 4) world alignment applied
#   tar_nrm              optional (H, V*W, 3)
#   near_far             (2,)
#   tar_rays             (V, H, W, 6)
#   tar_rays_down        (V, H/16, W/16, 6)
#   meta                 python dict (scene id, view ids, H, W)
BATCH_ARRAY_KEYS = (
    "fovx",
    "fovy",
    "tar_c2w",
    "tar_w2c",
    "tar_ixt",
    "tar_rgb",
    "tar_msk",
    "bg_color",
    "transform_mats",
    "near_far",
    "tar_rays",
    "tar_rays_down",
)

"""Instant3D dataset — reference ``dataLoader/instant3d.py``.

2x2-tiled 1024² PNGs split into 4 views; a fixed 4-camera rig loaded from
``opencv_cameras.json`` with positions scaled by 1/1.7.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .base import register_dataset
from .utils import align_first_view, build_rays_np, ixt_to_fov, build_rays_np as _rays


@register_dataset("instant3d")
class Instant3DDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.data_root = cfg.data_root
        self.img_size = np.array(cfg.img_size)
        self.img_paths = sorted(
            glob.glob(os.path.join(self.data_root, "*.png"))
            + glob.glob(os.path.join(self.data_root, "*.jpg"))
        )
        cam_path = os.path.join(self.data_root, "opencv_cameras.json")
        frames = json.load(open(cam_path))["frames"][:4]
        c2ws, ixts = [], []
        for fr in frames:
            w2c = np.array(fr["w2c"], np.float32)
            c2w = np.linalg.inv(w2c)
            c2w[:3, 3] /= 1.7
            c2ws.append(c2w)
            ixt = np.array(
                [
                    [fr["fx"], 0, fr["cx"]],
                    [0, fr["fy"], fr["cy"]],
                    [0, 0, 1],
                ],
                np.float32,
            )
            ixts.append(ixt)
        self.c2ws = np.stack(c2ws)
        self.ixts = np.stack(ixts)
        self.src_size = np.array([frames[0]["h"], frames[0]["w"]])

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, index):
        import imageio.v2 as imageio

        tile = imageio.imread(self.img_paths[index]).astype(np.float32) / 255.0
        if tile.shape[-1] == 4:
            tile = tile[..., :3] * tile[..., 3:] + (1 - tile[..., 3:])
        h2, w2 = tile.shape[0] // 2, tile.shape[1] // 2
        views = [
            tile[:h2, :w2], tile[:h2, w2:], tile[h2:, :w2], tile[h2:, w2:]
        ]
        H, W = self.img_size
        import cv2

        views = [cv2.resize(v, (int(W), int(H))) for v in views]
        imgs = np.stack(views).astype(np.float32)

        scale = np.array([W / w2, H / h2], np.float32)
        ixts = self.ixts.copy()
        ixts[:, 0] *= scale[0]
        ixts[:, 1] *= scale[1]

        c2ws = self.c2ws.copy()
        w2cs = np.linalg.inv(c2ws)
        c2ws, w2cs, tmats, r = align_first_view(c2ws, w2cs)
        fov = ixt_to_fov(ixts[0], [W, H])

        ret = {
            "fovx": np.float32(fov[0]),
            "fovy": np.float32(fov[1]),
            "tar_c2w": c2ws.astype(np.float32),
            "tar_w2c": w2cs.astype(np.float32),
            "tar_ixt": ixts.astype(np.float32),
            "tar_rgb": imgs,
            "tar_msk": np.ones(imgs.shape[:3], np.uint8),
            "bg_color": np.ones((4, 3), np.float32),
            "transform_mats": tmats,
            "near_far": np.array([r - 0.8, r + 0.8], np.float32),
            "meta": {
                "scene": os.path.basename(self.img_paths[index]).split(".")[0],
                "tar_view": [0, 1, 2, 3],
                "frame_id": 0,
                "tar_h": int(H),
                "tar_w": int(W),
            },
        }
        ret["tar_rays"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0)
        ret["tar_rays_down"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)
        return ret

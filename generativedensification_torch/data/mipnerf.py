"""MipNeRF-360 (LLFF-style) scene dataset — reference ``dataLoader/mipnerf.py``.

``poses_bounds.npy`` loader with pose centering and a random-4-view
sampler.  Scene-level extra beyond the object pipeline; kept minimal.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import register_dataset
from .utils import align_first_view, build_rays_np, fov_to_ixt


def _normalize(x):
    return x / np.linalg.norm(x)


def _center_poses(poses):
    """Standard LLFF pose centering: average pose -> identity."""
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    y_ = poses[:, :3, 1].sum(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    avg = np.stack([x, y, z, center], 1)
    avg44 = np.eye(4)
    avg44[:3] = avg
    return np.linalg.inv(avg44) @ poses


@register_dataset("mipnerf360")
class MipNeRF360Dataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.data_root = cfg.data_root
        self.split = cfg.split
        self.img_size = np.array(cfg.img_size)
        self.n_group = cfg.n_group
        self.rng = np.random.default_rng()

        pb = np.load(os.path.join(self.data_root, "poses_bounds.npy"))
        poses = pb[:, :15].reshape(-1, 3, 5)
        self.bounds = pb[:, 15:]
        hwf = poses[0, :, 4]
        self.src_hw = hwf[:2]
        self.focal = hwf[2]
        # LLFF [down right back] -> [right up back] -> opencv
        p = np.concatenate(
            [poses[:, :, 1:2], poses[:, :, 0:1], -poses[:, :, 2:3], poses[:, :, 3:4]],
            axis=-1,
        )
        p44 = np.tile(np.eye(4, dtype=np.float32), (len(p), 1, 1))
        p44[:, :3] = p
        self.c2ws = _center_poses(p44).astype(np.float32)

        img_dir = os.path.join(self.data_root, "images_4")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(self.data_root, "images")
        self.img_paths = sorted(
            glob.glob(os.path.join(img_dir, "*.jpg"))
            + glob.glob(os.path.join(img_dir, "*.png"))
        )

    def __len__(self):
        return max(len(self.img_paths) // (2 * self.n_group), 1)

    def __getitem__(self, index):
        import cv2
        import imageio.v2 as imageio

        n = len(self.img_paths)
        views = list(self.rng.choice(n, size=2 * self.n_group, replace=False))
        H, W = self.img_size
        imgs = []
        for v in views:
            img = imageio.imread(self.img_paths[v]).astype(np.float32) / 255.0
            img = cv2.resize(img[..., :3], (int(W), int(H)))
            imgs.append(img)
        c2ws = self.c2ws[views]
        w2cs = np.linalg.inv(c2ws)
        c2ws, w2cs, tmats, r = align_first_view(c2ws, w2cs)

        scale = np.array([W, H]) / self.src_hw[::-1]
        fx = self.focal * scale[0]
        fov = 2 * np.arctan2(np.array([W, H]) / 2, np.array([fx, self.focal * scale[1]]))
        ixt = fov_to_ixt(fov, [W, H])
        ixts = np.tile(ixt, (len(views), 1, 1)).astype(np.float32)

        near, far = self.bounds.min() * 0.9, self.bounds.max() * 1.1
        ret = {
            "fovx": np.float32(fov[0]),
            "fovy": np.float32(fov[1]),
            "tar_c2w": c2ws,
            "tar_w2c": w2cs,
            "tar_ixt": ixts,
            "tar_rgb": np.stack(imgs).astype(np.float32),
            "tar_msk": np.ones((len(views), int(H), int(W)), np.uint8),
            "bg_color": np.ones((len(views), 3), np.float32),
            "transform_mats": tmats,
            "near_far": np.array([near, far], np.float32),
            "meta": {
                "scene": os.path.basename(self.data_root),
                "tar_view": [int(v) for v in views],
                "frame_id": 0,
                "tar_h": int(H),
                "tar_w": int(W),
            },
        }
        ret["tar_rays"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0)
        ret["tar_rays_down"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)
        return ret

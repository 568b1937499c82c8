"""ShapeNet dataset — reference ``dataLoader/shapenet.py``.

Directory-of-scenes layout: each scene has ``rgb/*.png`` + ``pose/*.txt``
+ ``intrinsics.txt``; random 4 source + 4 target of the available views in
train, deterministic strides in test.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import register_dataset
from .utils import align_first_view, build_rays_np, composite_rgba, ixt_to_fov


@register_dataset("shapenet")
class ShapenetDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.data_root = cfg.data_root
        self.split = cfg.split
        self.img_size = np.array(cfg.img_size)
        self.n_group = cfg.n_group
        scenes = sorted(
            d for d in os.listdir(self.data_root)
            if os.path.isdir(os.path.join(self.data_root, d))
        )
        i_test = np.arange(len(scenes))[::10][: cfg.n_scenes]
        i_train = np.array(
            [i for i in np.arange(len(scenes)) if i not in i_test]
        )[: cfg.n_scenes]
        idx = i_train if self.split == "train" else i_test
        self.scenes = [scenes[i] for i in idx]
        self.rng = np.random.default_rng()

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, index):
        scene = self.scenes[index]
        root = os.path.join(self.data_root, scene)
        img_paths = sorted(glob.glob(os.path.join(root, "rgb", "*.png")))
        pose_paths = sorted(glob.glob(os.path.join(root, "pose", "*.txt")))
        n = len(img_paths)
        if self.split == "train":
            views = list(self.rng.choice(n, size=2 * self.n_group, replace=False))
        else:
            views = list(np.linspace(0, n - 1, 2 * self.n_group).astype(int))

        ixt = np.loadtxt(os.path.join(root, "intrinsics.txt")).reshape(-1)[:9].reshape(3, 3)
        H, W = self.img_size

        import imageio.v2 as imageio

        imgs, msks, c2ws = [], [], []
        bg = np.ones(3, np.float32)
        for v in views:
            img = imageio.imread(img_paths[v])
            if img.shape[-1] == 4:
                rgb, m = composite_rgba(img, bg)
            else:
                rgb = img.astype(np.float32) / 255.0
                m = np.ones(rgb.shape[:2], np.uint8)
            imgs.append(rgb)
            msks.append(m)
            c2ws.append(np.loadtxt(pose_paths[v]).reshape(4, 4).astype(np.float32))

        c2ws = np.stack(c2ws)
        w2cs = np.linalg.inv(c2ws)
        c2ws, w2cs, tmats, r = align_first_view(c2ws, w2cs)
        ixts = np.tile(ixt.astype(np.float32), (len(views), 1, 1))
        fov = ixt_to_fov(ixt, [W, H])

        ret = {
            "fovx": np.float32(fov[0]),
            "fovy": np.float32(fov[1]),
            "tar_c2w": c2ws,
            "tar_w2c": w2cs,
            "tar_ixt": ixts,
            "tar_rgb": np.stack(imgs),
            "tar_msk": np.stack(msks),
            "bg_color": np.tile(bg, (len(views), 1)),
            "transform_mats": tmats,
            "near_far": np.array([r - 0.8, r + 0.8], np.float32),
            "meta": {
                "scene": scene,
                "tar_view": [int(v) for v in views],
                "frame_id": 0,
                "tar_h": int(H),
                "tar_w": int(W),
            },
        }
        ret["tar_rays"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0)
        ret["tar_rays_down"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)
        return ret

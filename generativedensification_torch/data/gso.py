"""Google Scanned Objects dataset — reference
``dataLoader/google_scanned_objects.py``.

Folder-of-PNGs + per-scene ``transforms.json`` (per-frame c2w +
intrinsics).  Blender -> OpenCV camera flip; view groups from KMeans over
camera positions (source views = cluster-centroid-nearest frames, pruned
from the target groups); PFM depth maps for the depth metrics; fixed
near/far [0.5, 2.5].
"""

from __future__ import annotations

import json
import os

import numpy as np

from .base import register_dataset
from .utils import (
    align_first_view,
    build_rays_np,
    composite_rgba,
    ixt_to_fov,
    kmeans_groups,
    read_pfm,
)

_B2C = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64
)


@register_dataset("GSO")
class GSODataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.data_root = cfg.data_root
        self.split = cfg.split
        self.img_size = np.array(cfg.img_size)
        self.img_downscale = self.img_size / 512
        self.n_group = cfg.n_group
        self.scenes_name = np.array(
            [
                f
                for f in sorted(os.listdir(self.data_root))
                if os.path.isdir(os.path.join(self.data_root, f))
            ]
        )
        self.rng = np.random.default_rng()
        self._build_metas()

    def _build_metas(self):
        from sklearn.cluster import KMeans

        self.scene_infos = {}
        for scene in self.scenes_name:
            info = json.load(
                open(os.path.join(self.data_root, scene, "transforms.json"))
            )
            si = {
                "ixts": [], "c2ws": [], "w2cs": [], "img_paths": [],
                "depth_paths": [], "fovx": [], "fovy": [],
            }
            positions = []
            for idx, frame in enumerate(info["frames"]):
                c2w = np.array(frame["transform_matrix"]) @ _B2C
                ixt = np.array(frame["intrinsic_matrix"])
                fovx, fovy = ixt_to_fov(ixt, [2 * ixt[0, 2], 2 * ixt[1, 2]])
                si["ixts"].append(ixt.astype(np.float32))
                si["c2ws"].append(c2w.astype(np.float32))
                si["w2cs"].append(np.linalg.inv(c2w.astype(np.float32)))
                si["img_paths"].append(
                    os.path.join(self.data_root, scene, f"r_{idx:03d}.png")
                )
                si["depth_paths"].append(
                    os.path.join(self.data_root, scene, f"depth/r_{idx:03d}.pfm")
                )
                si["fovx"].append(fovx)
                si["fovy"].append(fovy)
                positions.append(c2w[:3, 3])
            positions = np.stack(positions)

            si["groups_4"] = kmeans_groups(positions, 4)
            km = KMeans(n_clusters=4, n_init=10).fit(positions)
            sampled = [
                int(np.argmin(np.linalg.norm(positions - km.cluster_centers_[i], axis=1)))
                for i in range(self.n_group)
            ]
            si["groups"] = sampled
            si["groups_4"] = [
                [x for x in g if x not in sampled] for g in si["groups_4"]
            ]
            self.scene_infos[scene] = si

    def __len__(self):
        return len(self.scene_infos)

    def _read_image(self, si, idx, bg_color):
        import imageio.v2 as imageio

        img = imageio.imread(si["img_paths"][idx])
        if (self.img_downscale != 1).any():
            import cv2

            img = cv2.resize(img, tuple(int(s) for s in self.img_size))
        rgb, mask = composite_rgba(img, bg_color)
        depth = None
        if os.path.exists(si["depth_paths"][idx]):
            depth, _ = read_pfm(si["depth_paths"][idx])
        return rgb, mask, depth

    def __getitem__(self, index):
        scene_name = str(self.scenes_name[index])
        si = self.scene_infos[scene_name]
        if self.split == "train":
            views = [
                int(self.rng.choice([si["groups"][i]]))
                for i in self.rng.permutation(self.n_group)
            ]
            views = views + [
                int(self.rng.choice([si["groups"][i]]))
                for i in self.rng.permutation(self.n_group)
            ]
        else:
            views = [si["groups"][i] for i in range(self.n_group)]
            views = views + [si["groups_4"][i][-1] for i in range(4)]

        bg = np.ones(3, np.float32)
        imgs, msks, deps, c2ws, w2cs, ixts = [], [], [], [], [], []
        for idx in views:
            rgb, mask, depth = self._read_image(si, idx, bg)
            imgs.append(rgb)
            msks.append(mask)
            if depth is not None:
                deps.append(depth)
            ixt = si["ixts"][idx].copy()
            ixt[:2] = ixt[:2] * self.img_downscale.reshape(2, 1)
            ixts.append(ixt)
            c2ws.append(si["c2ws"][idx])
            w2cs.append(si["w2cs"][idx])

        c2ws, w2cs, tmats, _ = align_first_view(np.stack(c2ws), np.stack(w2cs))
        ixts = np.stack(ixts)
        H, W = self.img_size
        ret = {
            "fovx": np.float32(si["fovx"][views[0]]),
            "fovy": np.float32(si["fovy"][views[0]]),
            "tar_c2w": c2ws,
            "tar_w2c": w2cs,
            "tar_ixt": ixts.astype(np.float32),
            "tar_rgb": np.stack(imgs),
            "tar_msk": np.stack(msks),
            "bg_color": np.tile(bg, (len(views), 1)),
            "transform_mats": tmats,
            "near_far": np.array([0.5, 2.5], np.float32),
            "meta": {
                "scene": scene_name,
                "tar_view": views,
                "frame_id": 0,
                "tar_h": int(H),
                "tar_w": int(W),
            },
        }
        if deps:
            ret["tar_dep"] = np.stack(deps)
        ret["tar_rays"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0)
        ret["tar_rays_down"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)
        return ret

"""Gobjaverse HDF5 dataset (LaRa format) — reference ``dataLoader/gobjverse.py``.

Schema per scene group: ``image_i`` (RGBA uint8), ``normal_i``, ``c2w_i``,
``fov_i``, and KMeans view-group indices ``groups/groups_{n}_{i}``; an
optional top-level ``splits`` group overrides the every-10th train/test
split.  Sampling recipe:
  * train: one random view per group as sources + one more random view per
    group as extra targets (8 views total at n_group=4),
  * test: deterministic first-of-group sources + last-of-group targets,
  * extra train target views get a random gray background (0 / 0.5 / 1).
"""

from __future__ import annotations

import numpy as np

from .base import register_dataset
from .utils import align_first_view, build_rays_np, composite_rgba, fov_to_ixt


@register_dataset("gobjeverse")
class GobjverseDataset:
    def __init__(self, cfg):
        import h5py

        self.cfg = cfg
        self.split = cfg.split
        self.img_size = np.array(cfg.img_size)
        self.n_group = cfg.n_group
        self.load_normal = bool(cfg.get("load_normal", False)) if hasattr(cfg, "get") else False
        self.metas = h5py.File(cfg.data_root, "r")

        names = np.array(sorted(self.metas.keys()))
        if "splits" in names:
            self.scenes_name = self.metas["splits"]["test"][:].astype(str)
        else:
            n_scenes = cfg.n_scenes
            i_test = np.arange(len(names))[::10][:n_scenes]
            i_train = np.array(
                [i for i in np.arange(len(names)) if i not in i_test]
            )[:n_scenes]
            self.scenes_name = (
                names[i_train] if self.split == "train" else names[i_test]
            )
        self.rng = np.random.default_rng()

    def __len__(self):
        return len(self.scenes_name)

    def _pick_views(self, scene):
        g = scene["groups"]
        n = self.n_group
        if self.split == "train" and n > 1:
            order = self.rng.permutation(n)
            src = [int(self.rng.choice(g[f"groups_{n}_{i}"][:])) for i in order]
            order2 = self.rng.permutation(n)
            extra = [int(self.rng.choice(g[f"groups_{n}_{i}"][:])) for i in order2]
            return src + extra
        if n == 1:
            src = [int(g["groups_4_0"][0])]
            return src + [int(g[f"groups_4_{i}"][-1]) for i in range(4)]
        src = [int(g[f"groups_{n}_{i}"][0]) for i in range(n)]
        return src + [int(g[f"groups_4_{i}"][-1]) for i in range(4)]

    def __getitem__(self, index):
        scene_name = str(self.scenes_name[index])
        scene = self.metas[scene_name]
        view_id = self._pick_views(scene)
        H, W = self.img_size

        imgs, bgs, nrms, msks, c2ws, w2cs, ixts = [], [], [], [], [], [], []
        for i, idx in enumerate(view_id):
            if self.split != "train" or i < self.n_group:
                bg = np.ones(3, np.float32)
            else:
                bg = np.ones(3, np.float32) * self.rng.choice([0.0, 0.5, 1.0])
            bgs.append(bg)
            rgb, msk = composite_rgba(np.array(scene[f"image_{idx}"]), bg)
            imgs.append(rgb)
            msks.append(msk)
            c2w = np.array(scene[f"c2w_{idx}"], np.float32)
            c2ws.append(c2w)
            w2cs.append(np.linalg.inv(c2w))
            fov = np.array(scene[f"fov_{idx}"], np.float32)
            ixts.append(fov_to_ixt(fov, self.img_size[::-1]))
            if self.load_normal:
                nrm = np.array(scene[f"normal_{idx}"], np.float32) / 255.0 * 2 - 1.0
                nrms.append(nrm)

        c2ws = np.stack(c2ws)
        w2cs = np.stack(w2cs)
        ixts = np.stack(ixts)
        c2ws, w2cs, tmats, r = align_first_view(c2ws, w2cs)

        fov0 = np.array(scene["fov_0"], np.float32)
        ret = {
            "fovx": fov0[0],
            "fovy": fov0[1],
            "tar_c2w": c2ws,
            "tar_w2c": w2cs,
            "tar_ixt": ixts,
            "tar_rgb": np.stack(imgs),
            "tar_msk": np.stack(msks),
            "transform_mats": tmats,
            "bg_color": np.stack(bgs),
            "near_far": np.array([r - 0.8, r + 0.8], np.float32),
            "meta": {
                "scene": scene_name,
                "tar_view": view_id,
                "frame_id": 0,
                "tar_h": int(H),
                "tar_w": int(W),
            },
        }
        if self.load_normal:
            nrm = np.stack(nrms) @ tmats[0, :3, :3].T
            ret["tar_nrm"] = nrm.transpose(1, 0, 2, 3).reshape(H, len(view_id) * W, 3)
        # full-res rays feed only the eval CLI's side outputs; the train
        # loop drops them — and building them is ~half the per-sample
        # host cost (292 of 612 ms at 512², r5).  ``load_rays: false``
        # skips them (train configs); the downsampled rays the network
        # conditions on are built directly at 1/16 scale either way.
        if bool(self.cfg.get("load_rays", True)):
            ret["tar_rays"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0)
        ret["tar_rays_down"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)
        return ret

"""Procedural synthetic data: the probe batch and the ``synthetic`` dataset.

Port of ``generativedensification_tpu/data/synthetic.py`` (numpy generation
from seeds, so both packages get the same scenes):

  * ``make_probe_batch`` — random images on a consistent orbit camera rig
    (no rendering, no IO), as tensors on a given device;
  * ``SyntheticDataset`` — random Gaussian-blob scenes on the orbit rig
    whose ground-truth views the port's own rasterizer renders (16 px
    tiles) on first access; samples are numpy dicts like every dataset's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .utils import align_first_view, build_rays_np, fov_to_ixt


def orbit_c2ws(n: int, radius: float = 1.9, elevation: float = 0.3):
    """n OpenCV-convention cameras orbiting the origin."""
    out = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.array([
            radius * np.cos(elevation) * np.sin(ang),
            radius * np.sin(elevation),
            -radius * np.cos(elevation) * np.cos(ang),
        ])
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
        out.append(c2w)
    return np.stack(out)


def make_probe_batch(B: int, V_total: int, H: int, W: int, n_views: int,
                     seed: int = 0, device=None) -> dict:
    """Random-image batch with a geometrically consistent orbit rig (no
    rendering, no IO).  ``device=None`` puts it on the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fov = 0.8
    c2ws = orbit_c2ws(V_total)
    w2cs = np.linalg.inv(c2ws)
    c2ws, w2cs, _, r = align_first_view(c2ws, w2cs)
    ixt = fov_to_ixt(np.array([fov, fov]), [W, H])
    ixts = np.tile(ixt, (V_total, 1, 1))
    rays_down = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)

    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    tile = lambda x: t(np.tile(x[None], (B,) + (1,) * x.ndim))
    return {
        "tar_rgb": t(rng.uniform(size=(B, V_total, H, W, 3)).astype(np.float32)),
        "tar_c2w": tile(c2ws),
        "tar_w2c": tile(w2cs),
        "tar_ixt": tile(ixts.astype(np.float32)),
        "fovx": t(np.full((B,), fov, np.float32)),
        "fovy": t(np.full((B,), fov, np.float32)),
        "near_far": t(np.tile([r - 0.8, r + 0.8], (B, 1)).astype(np.float32)),
        "bg_color": t(np.ones((B, V_total, 3), np.float32)),
        "tar_rays_down": tile(rays_down),
    }


class SyntheticDataset:
    """Random Gaussian-blob scenes; ground truth rendered by the port's
    ``rasterize`` on ``device`` (``None``: the card)."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.img_size = np.array(cfg.img_size)
        self.n_group = cfg.n_group
        self.n_scenes = min(int(cfg.n_scenes), 64)
        self.n_gaussians = int(cfg.get("n_gaussians", 512))
        self.fov = 0.8
        self._cache = {}

    def __len__(self):
        return self.n_scenes

    def _scene_gaussians(self, seed):
        rng = np.random.default_rng(seed)
        n = self.n_gaussians
        means = rng.uniform(-0.35, 0.35, size=(n, 3))
        shs = rng.normal(size=(n, 4, 3)) * 0.3
        shs[:, 0] += 0.6
        opa = rng.uniform(0.3, 0.95, size=(n,))
        scales = np.exp(rng.uniform(np.log(0.01), np.log(0.06), size=(n, 3)))
        quats = rng.normal(size=(n, 4))
        return means, shs, opa, scales, quats

    def _render_gt(self, seed, c2ws, ixts):
        from ..core.camera import Camera
        from ..core.transforms import normalize_quat
        from ..splat.rasterizer import rasterize

        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        means, shs, opa, scales, quats = map(t, self._scene_gaussians(seed))
        quats = normalize_quat(quats)
        H, W = (int(v) for v in self.img_size)
        cams = Camera.from_c2w(t(c2ws), self.fov, self.fov, W, H, znear=0.1,
                               zfar=10.0)
        bg = torch.ones(3, device=self.device)
        with torch.inference_mode():
            imgs = [
                rasterize(means, shs, opa, scales, quats, cams[j], bg, 1,
                          tile_size=16, max_tiles=16,
                          max_per_tile=min(2048, self.n_gaussians * 4)).image
                for j in range(c2ws.shape[0])
            ]
        return torch.stack(imgs).cpu().numpy()

    def __getitem__(self, index):
        if index in self._cache:
            return self._cache[index]
        V = 2 * self.n_group
        H, W = self.img_size
        c2ws = orbit_c2ws(V)
        w2cs = np.linalg.inv(c2ws)
        c2ws, w2cs, tmats, r = align_first_view(c2ws, w2cs)
        ixt = fov_to_ixt(np.array([self.fov, self.fov]), [W, H])
        ixts = np.tile(ixt, (V, 1, 1))

        imgs = self._render_gt(index, c2ws, ixts)
        ret = {
            "fovx": np.float32(self.fov),
            "fovy": np.float32(self.fov),
            "tar_c2w": c2ws,
            "tar_w2c": w2cs,
            "tar_ixt": ixts.astype(np.float32),
            "tar_rgb": imgs.astype(np.float32),
            "tar_msk": np.ones((V, int(H), int(W)), np.uint8),
            "bg_color": np.ones((V, 3), np.float32),
            "transform_mats": tmats,
            "near_far": np.array([r - 0.8, r + 0.8], np.float32),
            "meta": {
                "scene": f"synthetic_{index}",
                "tar_view": list(range(V)),
                "frame_id": 0,
                "tar_h": int(H),
                "tar_w": int(W),
            },
        }
        ret["tar_rays"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0)
        ret["tar_rays_down"] = build_rays_np(c2ws, ixts.copy(), H, W, 1.0 / 16)
        self._cache[index] = ret
        return ret

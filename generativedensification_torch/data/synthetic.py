"""Synthetic probe batch: random images on a consistent orbit camera rig.

Port of ``generativedensification_tpu/data/synthetic.py``'s
``make_probe_batch`` (numpy generation from a seed, so both packages get the
same batch), returning tensors on a given device.
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

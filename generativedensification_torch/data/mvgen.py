"""mvgen (text/image -> multi-view) front-end — interface stub.

The reference's ``dataLoader/mvgen.py`` wraps sv3d / zero123plus diffusion
pipelines to synthesize the 4 input views; it is registry-disabled in the
reference too (``dataLoader/__init__.py``, commented out — requires the
sv3d third_party checkout).  This stub keeps the dataset interface and the
canonical camera rig (``generate_input_camera`` equivalent) so a diffusion
front-end can be plugged in, and raises an informative error when the
generation backends are unavailable (zero-egress environment).
"""

from __future__ import annotations

import numpy as np


def generate_input_camera(r: float, poses_deg, fov: float = 50.0):
    """Canonical rig: (elevation, azimuth) degrees -> OpenCV c2w matrices
    looking at the origin from radius ``r`` (mvgen.py:305-341 behavior)."""
    out = []
    for elev, azim in poses_deg:
        e, a = np.deg2rad(elev), np.deg2rad(azim)
        eye = r * np.array(
            [np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)]
        )
        z = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
        out.append(c2w)
    ixt_fov = np.deg2rad(fov)
    return np.stack(out), ixt_fov


class MVGenDataset:
    """Interface stub: raises unless a generator callback is provided."""

    SUPPORTED = ("instant3d", "zero123plus-v1.1", "zero123plus-v1.2", "sv3d")

    def __init__(self, cfg, generator=None):
        self.cfg = cfg
        gen_type = cfg.get("generator_type", "instant3d")
        if gen_type not in self.SUPPORTED:
            raise NotImplementedError(f"unknown generator_type {gen_type!r}")
        if generator is None:
            raise NotImplementedError(
                "mvgen needs a diffusion generator (sv3d / zero123plus); "
                "those weights are not available in this environment. "
                "Pass `generator=callable(prompt_or_image) -> (4, H, W, 3)` "
                "or use the 'instant3d' dataset on pre-generated tiles."
            )
        self.generator = generator

    def __len__(self):
        return len(self.cfg.get("prompts", []) or self.cfg.get("image_pathes", []))

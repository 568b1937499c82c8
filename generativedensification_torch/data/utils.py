"""Host-side (numpy) camera utilities: intrinsics, rays, first-view
alignment.  Copies of ``generativedensification_tpu/data/utils.py``'s
functions (the port imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np


def fov_to_ixt(fov, img_size) -> np.ndarray:
    """(fovx, fovy) radians + (W, H)-ordered img_size -> (3, 3) intrinsics
    (principal point at size/2)."""
    fov = np.asarray(fov, np.float32)
    size = np.asarray(img_size, np.float32)
    focal = size / (2.0 * np.tan(fov / 2.0))
    ixt = np.eye(3, dtype=np.float32)
    ixt[0, 0], ixt[1, 1] = focal[0], focal[1]
    ixt[0, 2], ixt[1, 2] = size[0] / 2.0, size[1] / 2.0
    return ixt


def build_rays_np(c2ws: np.ndarray, ixts: np.ndarray, H: int, W: int,
                  scale: float = 1.0) -> np.ndarray:
    """(V, H', W', 6) [origin, direction] per pixel at ``scale``."""
    Hs, Ws = int(H * scale), int(W * scale)
    ixts = ixts.copy()
    ixts[:, :2] *= scale
    X, Y = np.meshgrid(np.arange(Ws), np.arange(Hs))
    pix = np.concatenate(
        [X[..., None] + 0.5, Y[..., None] + 0.5, np.ones_like(X[..., None])],
        axis=-1,
    ).astype(np.float32)
    i2w = np.linalg.inv(ixts).transpose(0, 2, 1) @ c2ws[:, :3, :3].transpose(0, 2, 1)
    dirs = np.einsum("hwc,vcd->vhwd", pix, i2w)
    origins = np.broadcast_to(c2ws[:, None, None, :3, 3], dirs.shape)
    return np.concatenate([origins, dirs], axis=-1).astype(np.float32)


def align_first_view(tar_c2ws: np.ndarray, tar_w2cs: np.ndarray):
    """The canonical "align cameras using first view" block."""
    r = np.linalg.norm(tar_c2ws[0, :3, 3])
    ref_c2w = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_w2c = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_c2w[:, 2, 3], ref_w2c[:, 2, 3] = -r, r
    transform_mats = ref_c2w @ tar_w2cs[:1]
    new_w2cs = tar_w2cs.copy() @ tar_c2ws[:1] @ ref_w2c
    new_c2ws = transform_mats @ tar_c2ws.copy()
    return (new_c2ws.astype(np.float32), new_w2cs.astype(np.float32),
            transform_mats.astype(np.float32), r)

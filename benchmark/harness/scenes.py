"""The scene generator: one reconstruction request per (seed, stream,
index), made on the host as a user's data loader hands it over.

The camera rig is the orbit of the port's ``data/synthetic.py::
make_probe_batch`` and ``data/utils.py`` (copied here, so that the
yardstick stays when the program changes): ``views_total`` cameras evenly
around the object, the first ``views_in`` of them the input views, aligned
on the first view as the reference's loaders do; the rig's radius,
elevation and azimuth and the images (uniform random RGB) are drawn per
request.  The sizes are the traffic file's and never depend on the seed.
"""

from __future__ import annotations

import numpy as np
import torch


def orbit_c2ws(n: int, radius: float, elevation: float, azimuth: float = 0.0):
    """n OpenCV-convention cameras orbiting the origin."""
    out = []
    for i in range(n):
        ang = azimuth + 2 * np.pi * i / n
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


def fov_to_ixt(fov, img_size) -> np.ndarray:
    fov = np.asarray(fov, np.float32)
    size = np.asarray(img_size, np.float32)
    focal = size / (2.0 * np.tan(fov / 2.0))
    ixt = np.eye(3, dtype=np.float32)
    ixt[0, 0], ixt[1, 1] = focal[0], focal[1]
    ixt[0, 2], ixt[1, 2] = size[0] / 2.0, size[1] / 2.0
    return ixt


def build_rays_np(c2ws, ixts, H: int, W: int, scale: float = 1.0):
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


def align_first_view(c2ws, w2cs):
    r = np.linalg.norm(c2ws[0, :3, 3])
    ref_c2w = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_w2c = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_c2w[:, 2, 3], ref_w2c[:, 2, 3] = -r, r
    new_w2cs = w2cs.copy() @ c2ws[:1] @ ref_w2c
    new_c2ws = (ref_c2w @ w2cs[:1]) @ c2ws.copy()
    return new_c2ws.astype(np.float32), new_w2cs.astype(np.float32), r


def scene(traffic: dict, seed: int, stream: int, index: int) -> dict:
    """One request's host tensors, (B, V_total, ...) as the port's batches."""
    B, V, S = traffic["batch"], traffic["views_total"], traffic["image_size"]
    ss = np.random.SeedSequence([seed % (1 << 64), stream, index])
    rng = np.random.default_rng(ss)
    radius = rng.uniform(*traffic["radius"])
    elevation = rng.uniform(*traffic["elevation"])
    azimuth = rng.uniform(0.0, 2.0 * np.pi)
    fov = traffic["fov"]
    c2ws = orbit_c2ws(V, radius, elevation, azimuth)
    c2ws, w2cs, r = align_first_view(c2ws, np.linalg.inv(c2ws))
    ixts = np.tile(fov_to_ixt([fov, fov], [S, S]), (V, 1, 1))
    rays_down = build_rays_np(c2ws, ixts, S, S, 1.0 / 16)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 62)))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
    tile = lambda x: t(np.tile(x[None], (B,) + (1,) * x.ndim))
    return {
        "tar_rgb": torch.rand((B, V, S, S, 3), generator=gen),
        "tar_c2w": tile(c2ws),
        "tar_w2c": tile(w2cs),
        "tar_ixt": tile(ixts.astype(np.float32)),
        "fovx": t(np.full((B,), fov, np.float32)),
        "fovy": t(np.full((B,), fov, np.float32)),
        "near_far": t(np.tile([r - 0.8, r + 0.8], (B, 1)).astype(np.float32)),
        "bg_color": t(np.ones((B, V, 3), np.float32)),
        "tar_rays_down": tile(rays_down),
    }


def to_device(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}

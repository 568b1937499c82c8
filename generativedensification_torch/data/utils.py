"""Host-side (numpy) data utilities: rays, intrinsics, KMeans view groups,
PFM depth reader — replaces ``dataLoader/utils.py``."""

from __future__ import annotations

import re

import numpy as np


def fov_to_ixt(fov, img_size) -> np.ndarray:
    """(fovx, fovy) radians + (W, H)-ordered img_size -> (3, 3) intrinsics
    (``dataLoader/utils.py:67-78`` convention: principal point at size/2)."""
    fov = np.asarray(fov, np.float32)
    size = np.asarray(img_size, np.float32)
    focal = size / (2.0 * np.tan(fov / 2.0))
    ixt = np.eye(3, dtype=np.float32)
    ixt[0, 0], ixt[1, 1] = focal[0], focal[1]
    ixt[0, 2], ixt[1, 2] = size[0] / 2.0, size[1] / 2.0
    return ixt


def ixt_to_fov(ixt: np.ndarray, img_size) -> np.ndarray:
    size = np.asarray(img_size, np.float32)
    return 2.0 * np.arctan2(size / 2.0, np.array([ixt[0, 0], ixt[1, 1]]))


def build_rays_np(c2ws: np.ndarray, ixts: np.ndarray, H: int, W: int, scale: float = 1.0):
    """numpy twin of core.rays.build_rays (``dataLoader/utils.py:21-34``)."""
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
    """The canonical "align cameras using first view" block
    (``dataLoader/gobjverse.py:68-75``), numpy."""
    r = np.linalg.norm(tar_c2ws[0, :3, 3])
    ref_c2w = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_w2c = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_c2w[:, 2, 3], ref_w2c[:, 2, 3] = -r, r
    transform_mats = ref_c2w @ tar_w2cs[:1]
    new_w2cs = tar_w2cs.copy() @ tar_c2ws[:1] @ ref_w2c
    new_c2ws = transform_mats @ tar_c2ws.copy()
    return new_c2ws.astype(np.float32), new_w2cs.astype(np.float32), transform_mats.astype(np.float32), r


def kmeans_groups(xyz: np.ndarray, n_clusters: int, seed: int = 20211202):
    """Cluster camera positions into view groups (``dataLoader/utils.py:57-66``)."""
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=n_clusters, n_init=10, random_state=seed)
    km.fit(xyz)
    return [np.where(km.labels_ == i)[0] for i in range(n_clusters)]


def read_pfm(path: str):
    """Portable float map reader (``dataLoader/utils.py:120-155``)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("latin-1"))
        if not dims:
            raise ValueError(f"malformed PFM header: {path}")
        width, height = map(int, dims.groups())
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.reshape(data, shape)[::-1], abs(scale)


def composite_rgba(img: np.ndarray, bg_color: np.ndarray):
    """uint8 RGBA -> float RGB over background + alpha mask
    (``gobjverse.py:140-146``)."""
    mask = (img[..., -1] > 0).astype(np.uint8)
    imgf = img.astype(np.float32) / 255.0
    rgb = imgf[..., :3] * imgf[..., -1:] + bg_color * (1.0 - imgf[..., -1:])
    return rgb.astype(np.float32), mask

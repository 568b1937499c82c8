"""Orbit / interpolated camera paths for video + mesh rendering.

Reference ``tools/gen_video_path.py``: per-dataset-family hard-coded start
pose orbited by z-rotation steps (gobjverse/GSO), the instant3d variant, an
interpolated path for unposed inputs, and the ``uni_video_path`` /
``uni_mesh_path`` dispatchers (3 elevation rings for TSDF fusion).

Port of ``generativedensification_tpu/tools/video_path.py``: the poses are
numpy, the cameras the port's ``Camera`` on ``device`` (``None``: the
card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.camera import Camera
from ..utils.device import resolve_device


def _rot(axis: str, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    if axis == "x":
        m[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
    elif axis == "y":
        m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    else:
        m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    return m


# hard-coded start poses of the reference orbit rigs
_GOBJ_START_R = np.array(
    [[0, 1.0, 0.0], [0.4515947, 0.0, -0.8922232], [-0.8922232, 0, -0.4515947]],
    np.float32,
).T
_GOBJ_START_T = np.array([1.70006549, 0.0, 0.8604804], np.float32)

_I3D_START_R = np.array(
    [
        [-7.0710677e-01, 2.4184476e-01, -6.6446304e-01],
        [7.0710677e-01, 2.4184476e-01, -6.6446304e-01],
        [-5.2163419e-17, -9.3969262e-01, -3.4202015e-01],
    ],
    np.float32,
)
_I3D_START_T = np.array([1.328926, 1.328926, 6.8404031e-01], np.float32)
_I3D_DEFAULT_TMAT = np.array(
    [
        [-7.0710677e-01, 7.0710677e-01, 7.8504622e-17, 0.0],
        [2.4184476e-01, 2.4184476e-01, -9.3969262e-01, 0.0],
        [-6.6446304e-01, -6.6446304e-01, -3.4202015e-01, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)


def _camera(c2w, fovx, fovy, width, height, znear, zfar, device):
    return Camera.from_c2w(torch.as_tensor(np.asarray(c2w, np.float32), device=device),
                           fovx, fovy, width, height, znear, zfar)


def _orbit(start_c2w, n, width, height, fovx, fovy, znear, zfar,
           transform_mats, elevation_deg=0.0, elev_axis="y", device=None):
    device = resolve_device(device)
    cams = []
    c2w = _rot(elev_axis, elevation_deg / 180.0 * math.pi) @ start_c2w
    step = _rot("z", 2 * math.pi / n)
    for _ in range(n):
        cams.append(_camera(transform_mats @ c2w, fovx, fovy, width, height,
                            znear, zfar, device))
        c2w = step @ c2w
    return cams


def gobjverse_frames(n, img_size, transform_mats=None, elevation=0.0, fov=None,
                     device=None):
    w, h = img_size
    fovx = fovy = 0.75
    t = np.eye(4, dtype=np.float32) if transform_mats is None else np.asarray(transform_mats)
    start = np.eye(4, dtype=np.float32)
    start[:3, :3] = _GOBJ_START_R
    start[:3, 3] = _GOBJ_START_T
    return _orbit(start, n, w, h, fovx, fovy, 0.5, 2.5, t, elevation, "y", device)


def instant3d_frames(n, img_size, transform_mats=None, elevation=0.0, fov=None,
                     device=None):
    w, h = img_size
    fovx, fovy = (0.7, 0.7) if fov is None else (float(fov[0]), float(fov[1]))
    t = _I3D_DEFAULT_TMAT if transform_mats is None else np.asarray(transform_mats)
    start = np.eye(4, dtype=np.float32)
    start[:3, :3] = _I3D_START_R
    start[:3, 3] = _I3D_START_T
    return _orbit(start, n, w, h, fovx, fovy, 1.0, 3.0, t, elevation, "x", device)


def interpolated_frames(n, img_size, c2ws, fov=(0.7, 0.7), znear=1.0, zfar=3.0,
                        device=None):
    """Slerp-interpolated path through given poses (unposed inputs)."""
    from .pose_interp import interpolate_poses

    device = resolve_device(device)
    w, h = img_size
    traj = interpolate_poses(np.asarray(c2ws), max(n // max(len(c2ws), 1), 1))
    return [_camera(c2w, fov[0], fov[1], w, h, znear, zfar, device) for c2w in traj]


def uni_video_path(n, dataset_name, img_size, transform_mats=None, sample=None, fov=None,
                   device=None):
    if dataset_name in ("gobjeverse", "GSO", "synthetic", "shapenet"):
        return gobjverse_frames(n, img_size, transform_mats, fov=fov, device=device)
    if dataset_name in ("instant3d", "mvgen"):
        return instant3d_frames(n, img_size, transform_mats, fov=fov, device=device)
    if dataset_name == "unposed":
        return interpolated_frames(n, img_size, sample["tar_c2w"][0], fov or (0.7, 0.7),
                                   device=device)
    raise NotImplementedError(dataset_name)


def uni_mesh_path(n, dataset_name, img_size, transform_mats=None, sample=None, fov=None,
                  device=None):
    """3 elevation rings x n frames for TSDF fusion."""
    cams = []
    for elev in (0.0, -30.0, 30.0):
        if dataset_name in ("gobjeverse", "GSO"):
            cams.extend(gobjverse_frames(n, img_size, transform_mats, elev, fov, device))
        else:
            cams.extend(instant3d_frames(n, img_size, transform_mats, elev, fov, device))
    return cams

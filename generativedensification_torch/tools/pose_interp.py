"""Pose interpolation: quaternion slerp chains (the subset of the
reference's nerfstudio-derived ``tools/camera_utils.py`` actually used,
``get_interpolated_poses_many``).

Port of ``generativedensification_tpu/tools/pose_interp.py``: numpy, with
the quaternion conversions of ``core/transforms.py`` in torch on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import normalize_quat, quat_to_rotmat, rotmat_to_quat


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    return (
        np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1
    ) / np.sin(theta)


def _order_poses(c2ws: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbor ordering of poses by camera position."""
    n = len(c2ws)
    pos = c2ws[:, :3, 3]
    remaining = list(range(1, n))
    order = [0]
    while remaining:
        cur = pos[order[-1]]
        nxt = min(remaining, key=lambda i: np.linalg.norm(pos[i] - cur))
        order.append(nxt)
        remaining.remove(nxt)
    return c2ws[order]


def interpolate_poses(c2ws: np.ndarray, steps_per_transition: int,
                      order_poses: bool = True) -> np.ndarray:
    """(N, 4, 4) keyframe poses -> densely slerped path."""
    c2ws = np.asarray(c2ws, np.float32)
    if c2ws.shape[-2] == 3:
        pad = np.tile(np.array([0, 0, 0, 1], np.float32), (len(c2ws), 1, 1))
        c2ws = np.concatenate([c2ws, pad.reshape(-1, 1, 4)], axis=1)
    if order_poses:
        c2ws = _order_poses(c2ws)
    out = []
    for a, b in zip(c2ws[:-1], c2ws[1:]):
        qa = rotmat_to_quat(torch.from_numpy(a[:3, :3].copy())).numpy()
        qb = rotmat_to_quat(torch.from_numpy(b[:3, :3].copy())).numpy()
        for s in range(steps_per_transition):
            t = s / steps_per_transition
            q = slerp(qa, qb, t)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = quat_to_rotmat(normalize_quat(
                torch.as_tensor(q, dtype=torch.float32))).numpy()
            m[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(m)
    out.append(c2ws[-1])
    return np.stack(out)

"""Turntable rendering of extracted meshes.

Equivalent of the reference's ``tools/meshRender.py`` (Mitsuba
path-traced turntable of the TSDF-extracted mesh,
`tools/meshRender.py:9-50`).  Mitsuba is not a dependency here; this is
a small self-contained z-buffer rasterizer (numpy) with two-sided
Lambertian shading + headlight, which covers the tool's actual use —
quick visual inspection videos of extracted geometry.

Port of ``generativedensification_tpu/tools/mesh_render.py`` (numpy, as
there).
"""

from __future__ import annotations

import numpy as np

from .video_path import _rot


def _look_at(eye, target, up=(0.0, 1.0, 0.0)):
    f = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r) + 1e-12
    u = np.cross(r, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, -u, f, eye
    return c2w


def render_mesh(verts, faces, c2w, fov=0.7, size=512, colors=None,
                bg=1.0, light_dir=None):
    """Rasterize a triangle mesh with a z-buffer; returns (H, W, 3) f32.

    Flat shading: albedo * max(n·l, 0.2 ambient), headlight by default.
    """
    H = W = int(size)
    w2c = np.linalg.inv(c2w)
    v_cam = (np.concatenate([verts, np.ones((len(verts), 1))], 1) @ w2c.T)[:, :3]
    focal = 0.5 * W / np.tan(0.5 * fov)
    z = np.clip(v_cam[:, 2], 1e-6, None)
    px = v_cam[:, 0] / z * focal + W / 2
    py = v_cam[:, 1] / z * focal + H / 2

    tri = faces.astype(np.int64)
    albedo = (
        np.full((len(verts), 3), 0.7) if colors is None else np.asarray(colors)
    )
    # per-face normal in camera space
    e1 = v_cam[tri[:, 1]] - v_cam[tri[:, 0]]
    e2 = v_cam[tri[:, 2]] - v_cam[tri[:, 0]]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
    ldir = np.asarray([0.0, 0.0, -1.0] if light_dir is None else light_dir)
    ldir = ldir / np.linalg.norm(ldir)
    shade = 0.2 + 0.8 * np.abs(n @ ldir)          # two-sided

    img = np.full((H, W, 3), float(bg), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)
    P = np.stack([px, py], axis=1)

    for f_idx in range(len(tri)):                  # any order; z-buffer decides
        i0, i1, i2 = tri[f_idx]
        p0, p1, p2 = P[i0], P[i1], P[i2]
        xmin = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
        xmax = min(int(np.ceil(max(p0[0], p1[0], p2[0]))) + 1, W)
        ymin = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
        ymax = min(int(np.ceil(max(p0[1], p1[1], p2[1]))) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            continue
        gx, gy = np.meshgrid(
            np.arange(xmin, xmax) + 0.5, np.arange(ymin, ymax) + 0.5
        )
        d = (p1[0] - p0[0]) * (p2[1] - p0[1]) - (p2[0] - p0[0]) * (p1[1] - p0[1])
        if abs(d) < 1e-12:
            continue
        w1 = ((gx - p0[0]) * (p2[1] - p0[1]) - (p2[0] - p0[0]) * (gy - p0[1])) / d
        w2 = ((p1[0] - p0[0]) * (gy - p0[1]) - (gx - p0[0]) * (p1[1] - p0[1])) / d
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        zi = w0 * z[i0] + w1 * z[i1] + w2 * z[i2]
        col = (
            w0[..., None] * albedo[i0]
            + w1[..., None] * albedo[i1]
            + w2[..., None] * albedo[i2]
        ) * shade[f_idx]
        ys, xs = np.nonzero(inside)
        yy, xx = ys + ymin, xs + xmin
        closer = zi[ys, xs] < zbuf[yy, xx]
        yy, xx, ys, xs = yy[closer], xx[closer], ys[closer], xs[closer]
        zbuf[yy, xx] = zi[ys, xs]
        img[yy, xx] = col[ys, xs].astype(np.float32)
    return img


def turntable_frames(verts, faces, n_frames=24, radius=None, elevation=0.35,
                     fov=0.7, size=512, colors=None):
    """Orbit the mesh (the reference's rotating-view Mitsuba loop)."""
    center = verts.mean(axis=0)
    if radius is None:
        radius = 2.5 * np.abs(verts - center).max()
    frames = []
    for i in range(n_frames):
        ang = 2.0 * np.pi * i / n_frames
        eye = center + radius * np.array(
            [np.sin(ang) * np.cos(elevation),
             np.sin(elevation),
             np.cos(ang) * np.cos(elevation)]
        )
        c2w = _look_at(eye, center)
        frames.append(render_mesh(verts, faces, c2w, fov, size, colors))
    return np.stack(frames)

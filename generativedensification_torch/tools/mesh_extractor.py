"""TSDF fusion + mesh extraction, PyTorch and numpy.

Port of ``generativedensification_tpu/tools/mesh_extractor.py`` (in place of
the reference ``tools/meshExtractor.py``, which fuses with Open3D's
``ScalableTSDFVolume``): fuse RGB-D renders of the fine Gaussians over
orbit cameras into a dense voxel TSDF, then extract the zero iso-surface
with *marching tetrahedra* (6-tet cube split, table-free and exact on the
tet interpolant), with a largest-connected-component filter; writes .obj
with vertex colors.

The integration is per-voxel elementwise work (about 134³ voxels at the
default voxel size over the unit box, per view), so it runs on the
renderer's device as torch tensors; marching tetrahedra, the component
filter and the .obj writer stay numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


class TSDFVolume:
    def __init__(self, aabb, voxel_size: float = 0.0075, sdf_trunc: float = 0.03,
                 device=None):
        dev = resolve_device(device)
        self.aabb = np.asarray(aabb, np.float32).reshape(2, 3)
        self.voxel_size = voxel_size
        self.trunc = sdf_trunc
        dims = np.ceil((self.aabb[1] - self.aabb[0]) / voxel_size).astype(int) + 1
        self.dims = dims
        shape = tuple(int(d) for d in dims)
        self.tsdf = torch.ones(shape, dtype=torch.float32, device=dev)
        self.weight = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.color = torch.zeros((*shape, 3), dtype=torch.float32, device=dev)
        ax = [self.aabb[0][i] + np.arange(dims[i]) * voxel_size for i in range(3)]
        g = np.stack(np.meshgrid(*ax, indexing="ij"), -1)
        self.points = torch.from_numpy(g.reshape(-1, 3).astype(np.float32)).to(dev)

    @torch.no_grad()
    def integrate(self, rgb, depth, alpha, cam, depth_trunc: float = 4.0,
                  alpha_thresh: float = 0.5):
        """Fuse one RGB-D render ((H, W, 3), (H, W), (H, W) tensors on the
        volume's device).  ``cam`` is a core Camera (single view)."""
        H, W = cam.height, cam.width
        pts = self.points
        p = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
        wvt = cam.world_view_transform.to(pts.device, torch.float32)
        pv = p @ wvt[:, :3]
        z = pv[:, 2]
        fx, fy = float(cam.focal_x), float(cam.focal_y)
        x = fx * pv[:, 0] / torch.clamp(z, min=1e-6) + (W - 1) / 2
        y = fy * pv[:, 1] / torch.clamp(z, min=1e-6) + (H - 1) / 2
        xi = torch.round(x).long()
        yi = torch.round(y).long()
        inb = (z > 0.05) & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c, yi_c = torch.clamp(xi, 0, W - 1), torch.clamp(yi, 0, H - 1)

        d = depth[yi_c, xi_c]
        a = alpha[yi_c, xi_c]
        c = rgb[yi_c, xi_c]
        valid = inb & (a > alpha_thresh) & (d > 0.05) & (d < depth_trunc)

        sdf = (d - z) / self.trunc
        upd = valid & (sdf > -1.0)
        sdf = torch.clamp(sdf, -1.0, 1.0)

        t = self.tsdf.view(-1)
        wgt = self.weight.view(-1)
        col = self.color.view(-1, 3)
        w_new = wgt + 1.0
        t.copy_(torch.where(upd, (t * wgt + sdf) / w_new, t))
        col.copy_(torch.where(upd[:, None], (col * wgt[:, None] + c) / w_new[:, None], col))
        wgt.copy_(torch.where(upd, w_new, wgt))

    def extract_mesh(self, min_weight: float = 1.0, keep_largest: bool = True):
        """Zero-isosurface triangles via marching tetrahedra (numpy)."""
        weight = self.weight.cpu().numpy()
        mask = weight >= min_weight
        vol = np.where(mask, self.tsdf.cpu().numpy(), 1.0)
        verts, faces = marching_tetrahedra(vol, iso=0.0)
        if len(verts) == 0:
            return verts, faces, np.zeros((0, 3), np.float32)
        # vertex colors by trilinear sample of the color grid
        vcol = _trilinear(self.color.cpu().numpy(), verts)
        verts_world = self.aabb[0] + verts * self.voxel_size
        if keep_largest and len(faces):
            faces, _ = _largest_component(faces, len(verts))
        return verts_world.astype(np.float32), faces, vcol


def _trilinear(grid, pts):
    p0 = np.floor(pts).astype(int)
    f = pts - p0
    dims = np.array(grid.shape[:3])
    out = np.zeros((len(pts), grid.shape[-1]), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = np.minimum(p0 + [dx, dy, dz], dims - 1)
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                out += w[:, None] * grid[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


# the 6-tetrahedra decomposition of a cube around the 0-7 diagonal
# (corner index bits = (x, y, z))
_TETS = np.array(
    [[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7], [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]]
)
_CUBE = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
)


def marching_tetrahedra(vol: np.ndarray, iso: float = 0.0):
    """Extract the iso-surface of a 3D scalar grid.

    Returns (verts (M, 3) in grid coordinates, faces (F, 3) int).
    Vectorized over all tets; vertices are deduplicated by edge key.
    """
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    bx, by, bz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([bx, by, bz], -1).reshape(-1, 1, 3)        # (C, 1, 3)
    corners = base + _CUBE[None]                                # (C, 8, 3)
    vals = vol[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)

    tri_list = []
    for tet in _TETS:
        tv = vals[:, tet]                                      # (C, 4)
        tc = corners[:, tet]                                   # (C, 4, 3)
        inside = tv < iso                                      # (C, 4)
        code = (
            inside[:, 0].astype(int)
            + 2 * inside[:, 1]
            + 4 * inside[:, 2]
            + 8 * inside[:, 3]
        )

        def edge_point(ci, a, b):
            va, vb = tv[ci, a], tv[ci, b]
            t = (iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tc[ci, a] * (1 - t) + tc[ci, b] * t

        # single-vertex-inside cases (and complements) -> 1 triangle,
        # two-inside cases -> 2 triangles
        cases_1 = {1: (0, (1, 2, 3)), 2: (1, (0, 3, 2)), 4: (2, (0, 1, 3)), 8: (3, (0, 2, 1))}
        for code_val, (vin, others) in cases_1.items():
            for cv, flip in ((code_val, False), (15 - code_val, True)):
                ci = np.where(code == cv)[0]
                if len(ci) == 0:
                    continue
                p = [edge_point(ci, vin, o) for o in others]
                tri = np.stack(p, axis=1)
                if flip:
                    tri = tri[:, ::-1]
                tri_list.append(tri)
        cases_2 = {
            3: ((0, 1), (2, 3)),   # verts 0,1 inside
            5: ((0, 2), (3, 1)),
            9: ((0, 3), (1, 2)),
        }
        for code_val, (ins, outs) in cases_2.items():
            for cv, flip in ((code_val, False), (15 - code_val, True)):
                ci = np.where(code == cv)[0]
                if len(ci) == 0:
                    continue
                a, b = ins
                c, d = outs
                pac = edge_point(ci, a, c)
                pad = edge_point(ci, a, d)
                pbc = edge_point(ci, b, c)
                pbd = edge_point(ci, b, d)
                t1 = np.stack([pac, pad, pbd], axis=1)
                t2 = np.stack([pac, pbd, pbc], axis=1)
                if flip:
                    t1, t2 = t1[:, ::-1], t2[:, ::-1]
                tri_list.append(t1)
                tri_list.append(t2)

    if not tri_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tris = np.concatenate(tri_list, axis=0)                     # (F, 3, 3)
    flat = tris.reshape(-1, 3)
    # dedup vertices
    key = np.round(flat / 1e-5).astype(np.int64)
    _, idx, inv = np.unique(
        key.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]),
        return_index=True,
        return_inverse=True,
    )
    verts = flat[idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good]


def _largest_component(faces, n_verts):
    """Keep faces of the largest vertex-connected component (union-find)."""
    parent = np.arange(n_verts)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(v) for v in range(n_verts)])
    face_root = roots[faces[:, 0]]
    vals, counts = np.unique(face_root, return_counts=True)
    big = vals[np.argmax(counts)]
    keep = face_root == big
    return faces[keep], None


def save_obj(path, verts, faces, colors=None):
    with open(path, "w") as f:
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


class MeshExtractor:
    """Render-and-fuse loop (reference ``meshExtractor.py:31-139``): RGB-D
    renders of the Gaussians through ``renderer.render_img`` (the 3DGS
    ``Renderer``: image, depth, acc_map), fused on the renderer's device."""

    def __init__(self, renderer, aabb, voxel_size=0.0075, sdf_trunc=0.03):
        self.renderer = renderer
        self.aabb = aabb
        self.voxel_size = voxel_size
        self.sdf_trunc = sdf_trunc

    @torch.no_grad()
    def fuse(self, gaussians, cams, **render_kw) -> TSDFVolume:
        """The TSDF of the views ``cams``."""
        vol = TSDFVolume(self.aabb, self.voxel_size, self.sdf_trunc,
                         self.renderer.device)
        centers, shs, opacity, scales, rotations = gaussians
        for cam in cams:
            out = self.renderer.render_img(cam, None, centers, shs, opacity, scales,
                                           rotations, **render_kw)
            depth = out["depth"][..., 0]
            alpha = out["acc_map"]
            # expected depth -> metric depth
            d = torch.where(alpha > 1e-3, depth / torch.clamp(alpha, min=1e-3), 0.0)
            vol.integrate(out["image"], d, alpha, cam)
        return vol

    def extract(self, gaussians, cams, **render_kw):
        """(verts, faces, vertex colors) of the fused views."""
        return self.fuse(gaussians, cams, **render_kw).extract_mesh()

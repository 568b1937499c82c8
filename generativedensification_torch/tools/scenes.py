"""The seeded scenes on which the compositor kernels are measured, as the
kernels' own inputs (projected or set up, binned and packed by the port).

- scene A: ``bench.py``'s scene (512², 131,072 Gaussians from seed 0),
  ``bench_scene``; its surfel form A′ (``scripts/dev_surfel_break.py``: 2-D
  scales in [0.002, 0.01], or [0.004, 0.02] with ``scales="free"``),
  ``surfel_bench_scene``;
- scene B / B′: the 262,144 coarse Gaussians / surfels of the full-width
  serving network from seed 0 on the probe batch, in view 0
  (``model_view`` and ``model_gaussians`` / ``model_surfels``);
- a small surfel scene (256², 20,000 surfels), ``surfel_scene``;
- the pre-pass scene (``prepass_scene``: the rasterizer's inputs, up to the
  serving networks' 262,144 coarse and 331,744 fine Gaussians at 512², a
  tenth of them off-screen or behind the camera);
- the adversarial scene of the compositors' footprint skip (256²,
  ``adversarial_scene``), of the surfel kernels' screen-circle skip
  (``surfel_adversarial_scene``), and of the surfel set-up kernel
  (``surfel_setup_scene``: 512², 262,144 surfels).

The budgets (``max_tiles``, ``enum_tiles``, ``max_per_tile``) default to the
serving configuration's and can be set to the train step's warmup budgets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_infer_config
from ..core.camera import Camera
from ..core.transforms import normalize_quat
from ..splat.binning import bin_gaussians
from ..splat.composite import pack_table
from ..splat.projection import ProjectedGaussians, project_gaussians
from ..splat.surfel import (
    SurfelInputs,
    _surfel_coeffs,
    _surfel_setup,
    pack_surfel_table,
    surfel_inputs,
)


def fine_config(**over):
    """The serving configuration: the infer defaults (``mask_pool`` 262144)
    in f32, built without PyYAML."""
    cfg = default_infer_config()
    cfg.set_dotted("tpu.compute_dtype", "float32")
    for k, v in over.items():
        cfg.set_dotted(k, v)
    return cfg


def compositor_inputs(means, shs, opa, scales, quats, cam, tile_size,
                      max_tiles, max_per_tile, enum_tiles=None):
    """Project + bin one view with the port's own functions.  Returns the
    forward kernel's arguments, the pairs the budgets dropped, and the
    ``bins`` that ``composite.composite_backward`` takes."""
    proj = project_gaussians(means, shs, opa, cam, 1, scales,
                             normalize_quat(quats))
    return projected_inputs(proj, cam.height, cam.width, tile_size, max_tiles,
                            max_per_tile, enum_tiles)


def projected_inputs(proj, height, width, tile_size, max_tiles, max_per_tile,
                     enum_tiles=None):
    """``compositor_inputs`` from projected Gaussians: bin and pack."""
    n = proj.xy.shape[0]
    bins = bin_gaussians(proj, height, width, tile_size=tile_size,
                         max_tiles=max_tiles, enum_tiles=enum_tiles or None)
    opa_eff = torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))
    table = pack_table(proj.xy, proj.conic, proj.color, opa_eff, proj.depth,
                       proj.valid)
    counts = torch.clamp(bins.tile_counts, max=min(max_per_tile, n * max_tiles))
    overflow = int(bins.overflow) + int((bins.tile_counts - counts).sum())
    args = (table, bins.sorted_ids, bins.tile_starts, counts, bins.tiles_x,
            bins.tiles_y, tile_size)
    back = (bins.sorted_ids, bins.sorted_o, bins.depth_order, bins.tile_starts,
            counts, n * max_tiles)
    return args, overflow, back


def surfel_kernel_inputs(means, shs, opa, scales2d, quats, cam, tile_size,
                         max_tiles, max_per_tile, enum_tiles=None):
    """Set up and bin one view's surfels with the port's own functions (the
    part of ``rasterize_surfels`` before compositing); returns the kernels'
    inputs and the ``SurfelInputs`` record."""
    si = surfel_inputs(means, shs, opa, scales2d, quats, cam, 1, tile_size,
                       max_tiles, max_per_tile, enum_tiles or None)
    table = pack_surfel_table(*si.attrs)
    ids, _, _, starts, counts = si.bins
    return (table, ids, starts, counts, si.planes, *si.dims), si


def _bench_arrays(dev, n, hw, scale_dims, smin=0.002, smax=0.01):
    """``bench.py``'s generator calls (seed 0): means, SH, opacity, scales,
    rotations and its camera at ``hw``²."""
    rng = np.random.default_rng(0)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.45, 0.45, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,)) - 1.0))
    scales = torch.exp(f(rng.uniform(np.log(smin), np.log(smax),
                                     size=(n, scale_dims))))
    quats = f(rng.normal(size=(n, 4)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, hw, hw, znear=0.1, zfar=10.0)
    return means, shs, opa, scales, quats, cam


def bench_scene(dev, tile_size=32, max_tiles=4, n=131072, hw=512,
                max_per_tile=4096, enum_tiles=None):
    """Scene A: ``bench.py``'s scene (512², 131,072 Gaussians, seed 0), at
    its tile size and budgets; ``compositor_inputs``' three values."""
    means, shs, opa, scales, quats, cam = _bench_arrays(dev, n, hw, 3)
    return compositor_inputs(means, shs, opa, scales, quats, cam, tile_size,
                             max_tiles, max_per_tile, enum_tiles)


def prepass_scene(dev, n, height=512, width=None, seed=0, sh_degree=1,
                  smax=0.03):
    """The pre-pass scene: ``rasterize``'s inputs (means, SH of
    ``sh_degree``, activated opacity and scales, raw quaternions, camera) for
    ``n`` Gaussians from ``seed`` at ``height`` x ``width`` (square by
    default).  Nine tenths lie in scene A's cube with scales in [0.002,
    ``smax``] (at 512² the largest cover 3 x 3 tiles of 32 px: the serving
    budget of 4 drops some); the rest lie in a cube 18 times as wide, off
    the screen or behind the camera."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    far = rng.uniform(size=n) < 0.1
    means = rng.uniform(-0.45, 0.45, size=(n, 3))
    means[far] *= 18.0
    shs = f(rng.normal(size=(n, (sh_degree + 1) ** 2, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,)) - 0.5))
    scales = torch.exp(f(rng.uniform(np.log(0.002), np.log(smax), size=(n, 3))))
    quats = f(rng.normal(size=(n, 4)))
    # a camera 1.9 from the cube's centre, turned 0.7 rad about a seeded axis
    axis = rng.normal(size=3)
    k = np.cross(np.eye(3), axis / np.linalg.norm(axis))
    rot = np.eye(3) + np.sin(0.7) * k + (1.0 - np.cos(0.7)) * k @ k
    c2w = np.eye(4)
    c2w[:3, :3] = rot
    c2w[:3, 3] = -rot @ np.array([0.0, 0.0, 1.9])
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8 * height / (width or height),
                          width or height, height, znear=0.1, zfar=10.0)
    return f(means), shs, opa, scales, quats, cam


def _quat_of(rot):
    """wxyz quaternions (n, 4) of rotation matrices (n, 3, 3)."""
    w = np.sqrt(np.maximum(1.0 + rot[:, 0, 0] + rot[:, 1, 1] + rot[:, 2, 2], 1e-12)) / 2
    x = np.sqrt(np.maximum(1.0 + rot[:, 0, 0] - rot[:, 1, 1] - rot[:, 2, 2], 0.0)) / 2
    y = np.sqrt(np.maximum(1.0 - rot[:, 0, 0] + rot[:, 1, 1] - rot[:, 2, 2], 0.0)) / 2
    z = np.sqrt(np.maximum(1.0 - rot[:, 0, 0] - rot[:, 1, 1] + rot[:, 2, 2], 0.0)) / 2
    x = np.copysign(x, rot[:, 2, 1] - rot[:, 1, 2])
    y = np.copysign(y, rot[:, 0, 2] - rot[:, 2, 0])
    z = np.copysign(z, rot[:, 1, 0] - rot[:, 0, 1])
    return np.stack([w, x, y, z], -1)


def surfel_setup_scene(dev, n=262144, hw=512, seed=0):
    """The surfel set-up's adversarial scene: ``rasterize_surfels``' inputs
    (means, degree-1 SH, activated opacity, 2-D scales, raw quaternions,
    camera: ``prepass_scene``'s) for ``n`` surfels at ``hw``², built in view
    space, six tenths ordinary and a tenth in each other group:

    - ordinary surfels over the screen and 32 px around it;
    - edge-on surfels: the normal across the view ray up to 1e-6-1e-3 rad,
      so that n·p (the flip) and det(M) (the depth pole z = det / cr_z) sit
      near 0;
    - centres around the near cull, view z in [-0.3, 0.4];
    - centres at z in [0.2, 0.5] with axes long enough that a ±3σ endpoint
      falls around z = 0.05;
    - centres just off the screen: beyond an edge by 0.8-1.8 of a screen
      radius of 2-40 px, plus the filter margin;
    - over the whole scene, a tenth of the opacities from {0, 1e-13, 1e-12,
      2e-12, 1/255 and its float32 neighbours, 0.5, 1}, and one in 200 each
      with zero scales or a zero quaternion."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    *_, cam = prepass_scene("cpu", 1, hw, seed=seed)
    fx, c = float(cam.focal_x), (hw - 1) / 2.0
    m = n // 10
    group = np.clip(np.arange(n) // m - 5, 0, 4)   # 0 ordinary, the first 6 tenths
    z = rng.uniform(0.8, 3.0, n)
    pix = rng.uniform(-32.0, hw + 32.0, (n, 2))
    scales = np.exp(rng.uniform(np.log(0.002), np.log(0.05), (n, 2)))
    quats = rng.normal(size=(n, 4))
    z = np.where(group == 2, rng.uniform(-0.3, 0.4, n), z)
    z = np.where(group == 3, rng.uniform(0.2, 0.5, n), z)
    scales = np.where((group == 3)[:, None],
                      np.exp(rng.uniform(np.log(0.02), np.log(0.3), (n, 2))), scales)
    # just off the screen: the centre beyond an edge by 0.8-1.8 of a face-on
    # screen radius r, plus the filter margin
    r = rng.uniform(2.0, 40.0, n)
    edge = rng.integers(0, 4, n)
    beyond = r * rng.uniform(0.8, 1.8, n) + 4.2
    off = np.where(edge % 2 == 0, -beyond, hw - 1.0 + beyond)
    axis = edge // 2
    pix[group == 4, 0] = np.where(axis == 0, off, pix[:, 0])[group == 4]
    pix[group == 4, 1] = np.where(axis == 1, off, pix[:, 1])[group == 4]
    scales = np.where((group == 4)[:, None], (r * z / (3.0 * fx))[:, None], scales)
    view = np.stack([(pix[:, 0] - c) * z / fx, (pix[:, 1] - c) * z / fx, z], -1)
    # edge-on: a rotation whose third column (the normal) is across the ray
    edge_on = group == 1
    k = int(edge_on.sum())
    ray = view[edge_on] / np.linalg.norm(view[edge_on], axis=1, keepdims=True)
    nrm = np.cross(ray, rng.normal(size=(k, 3)))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tilt = np.exp(rng.uniform(np.log(1e-6), np.log(1e-3), k))[:, None]
    nrm = nrm + tilt * rng.choice([-1.0, 1.0], (k, 1)) * ray
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tu = np.cross(nrm, rng.normal(size=(k, 3)))
    tu /= np.linalg.norm(tu, axis=1, keepdims=True)
    R_c2w = cam.world_view_transform[:3, :3].double().numpy()     # view -> world
    rot_view = np.stack([tu, np.cross(nrm, tu), nrm], -1)
    quats[edge_on] = _quat_of(R_c2w @ rot_view)
    c2w_t = -cam.camera_center.double().numpy()
    means = view @ R_c2w.T + c2w_t
    opa = 1.0 / (1.0 + np.exp(-rng.normal(size=n)))
    special = np.array([0.0, 1e-13, 1e-12, 2e-12, np.nextafter(np.float32(1 / 255), 0),
                        np.float32(1 / 255), np.nextafter(np.float32(1 / 255), 1), 0.5, 1.0])
    pick = rng.uniform(size=n) < 0.1
    opa[pick] = rng.choice(special, int(pick.sum()))
    scales[rng.uniform(size=n) < 0.005] = 0.0
    quats[rng.uniform(size=n) < 0.005] = 0.0
    shs = rng.normal(size=(n, 4, 3)) * 0.3 + 0.2
    cam_dev = Camera(**{k_: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                        for k_, v in vars(cam).items()})
    return f(means), f(shs), f(opa), f(scales), f(quats), cam_dev


def surfel_bench_inputs(dev, scales="default", n=131072, hw=512):
    """Scene A′'s surfels as ``surfel.surfel_setup`` takes them (means, 2-D
    scales, raw quaternions, opacity, SH, camera)."""
    smin, smax = (0.004, 0.02) if scales == "free" else (0.002, 0.01)
    means, shs, opa, s2, quats, cam = _bench_arrays(dev, n, hw, 2, smin, smax)
    return means, s2, quats, opa, shs, cam


def surfel_bench_scene(dev, scales="default", tile_size=32, max_tiles=4,
                       n=131072, hw=512, max_per_tile=4096, enum_tiles=None):
    """Scene A′: the surfel form of scene A (``scripts/dev_surfel_break.py``),
    2-D scales in [0.002, 0.01], or [0.004, 0.02] with ``scales="free"``."""
    means, s2, quats, opa, shs, cam = surfel_bench_inputs(dev, scales, n, hw)
    return surfel_kernel_inputs(means, shs, opa, s2, normalize_quat(quats), cam,
                                tile_size, max_tiles, max_per_tile, enum_tiles)


def surfel_scene(dev):
    """A small surfel scene: 256², 20,000 surfels (the JAX surfel parity
    scene's distributions, ``tests/test_pallas_surfel.py``), seed 0."""
    rng = np.random.default_rng(0)
    n = 20000
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.35, 0.35, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,))))
    scales = f(np.exp(rng.uniform(np.log(0.01), np.log(0.03), size=(n, 2))))
    quats = normalize_quat(f(rng.normal(size=(n, 4))))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, 256, 256, znear=0.2, zfar=4.0)
    return surfel_kernel_inputs(means, shs, opa, scales, quats, cam, 32, 4, 4096)


def model_view(renderer: str, dev):
    """The full-width serving network with ``tpu.renderer=renderer`` from
    seed 0 on ``make_probe_batch(B=1, V_total=8, 512², n_views=4, seed=0)``
    (``chip_smoke.py``'s batch): a coarse forward's primitives
    (``render_pkg[0]``), view 0's camera and the network configuration."""
    from ..data.synthetic import make_probe_batch
    from ..models.network import Network, NetworkConfig

    cfg = NetworkConfig.from_config(fine_config(**{"tpu.renderer": renderer}))
    net = Network(cfg, device=dev, seed=0)
    net.eval()
    batch = make_probe_batch(1, 8, 512, 512, n_views=4, seed=0, device=dev)
    with torch.inference_mode():
        pkg = net(batch, with_fine=False)["render_pkg"][0]
    return pkg, net._cameras_all(batch)[0][0], cfg


def model_gaussians(pkg, cam, cfg, tile_size=None, max_tiles=None,
                    max_per_tile=None, enum_tiles=None):
    """Scene B: a forward's coarse Gaussians ``pkg`` (``render_pkg[0]``) of
    batch element 0 in camera ``cam``, binned with the configuration's
    budgets (or the given tile size and budgets);
    ``compositor_inputs``' three values."""
    centers, shs, opacity, scaling, rotation = pkg
    return compositor_inputs(
        centers[0], shs[0], torch.sigmoid(opacity[0, :, 0]), torch.exp(scaling[0]),
        rotation[0], cam, tile_size or cfg.tile_size, max_tiles or cfg.max_tiles,
        max_per_tile or cfg.max_per_tile, enum_tiles or cfg.enum_tiles)


def model_surfels(pkg, cam, cfg, tile_size=None, max_tiles=None,
                  max_per_tile=None, enum_tiles=None):
    """Scene B′: as ``model_gaussians`` for the coarse surfels of a 2DGS
    forward; ``surfel_kernel_inputs``' two values."""
    centers, shs, opacity, scaling, rotation = pkg
    return surfel_kernel_inputs(
        centers[0], shs[0], torch.sigmoid(opacity[0, :, 0]),
        torch.exp(scaling[0])[:, :2], rotation[0], cam,
        tile_size or cfg.tile_size, max_tiles or cfg.max_tiles,
        max_per_tile or cfg.max_per_tile, enum_tiles or cfg.enum_tiles)


def _conic_of(rng, n, sig_lo, sig_hi, aniso=1.0):
    """(n, 3) conics (a, b, c) and 3-sigma radii of random 2-D covariances
    R diag(s1², s2²) Rᵀ + 0.3 I (the projection's dilation), s1 in
    [sig_lo, sig_hi] and s2 = s1 × [1, aniso]."""
    s1 = np.exp(rng.uniform(np.log(sig_lo), np.log(sig_hi), n))
    s2 = s1 * np.exp(rng.uniform(0.0, np.log(aniso), n)) if aniso > 1 else s1
    th = rng.uniform(0, np.pi, n)
    co, si = np.cos(th), np.sin(th)
    ca = co * co * s1 ** 2 + si * si * s2 ** 2 + 0.3
    cb = co * si * (s1 ** 2 - s2 ** 2)
    cc = si * si * s1 ** 2 + co * co * s2 ** 2 + 0.3
    det = ca * cc - cb * cb
    conic = np.stack([cc / det, -cb / det, ca / det], -1)
    radius = np.ceil(3.0 * np.sqrt(np.maximum(s1, s2) ** 2 + 0.3))
    return conic, radius


def adversarial_scene(dev, tile_size=32, seed=0, hw=256):
    """The footprint skip's adversarial scene at ``hw``² (seeded): opaque
    Gaussians (opacity 0.95-1) in front over the left half, with more than a
    staging batch of others behind them, so that pixels, sub-tiles and tiles
    saturate and stop early; Gaussians centred 0.5-2 px
    outside a sub-tile's pixel-centre rectangle (beside an edge or a
    corner) whose opacity puts alpha at the rectangle's nearest pixel within
    ±0.1% of 1/255; opacities at 1/255 and just above it; near-singular
    conics (covariance eigenvalues up to 1e7 px²), near-isotropic ones
    (eigenvalue gap ~1e-6) and a few that are not positive definite; and
    about 3% of the rows marked invalid in the table after binning (their
    folded opacity is 0).  Binned with ``max_tiles`` = every tile of the
    view, so nothing overflows; the counts are those of a 256² view scaled
    to ``hw``²; ``compositor_inputs``' three values."""
    rng = np.random.default_rng(seed)
    parts = []   # (xy, conic, radius, opacity, depth)
    size = lambda n: max(1, round(n * hw * hw / 256 ** 2))   # counts per 256²

    left = lambda n: np.stack([rng.uniform(0, hw / 2, n), rng.uniform(0, hw, n)], -1)
    n = size(1500)  # saturating, left half, in front
    conic, radius = _conic_of(rng, n, 3.0, 8.0, aniso=2.0)
    parts.append((left(n), conic, radius, rng.uniform(0.95, 1.0, n),
                  rng.uniform(0.5, 1.5, n)))
    n = size(2500)  # behind them: more than a batch
    conic, radius = _conic_of(rng, n, 1.0, 3.0, aniso=2.0)
    parts.append((left(n), conic, radius, rng.uniform(0.1, 0.9, n),
                  rng.uniform(5.0, 6.0, n)))

    n = size(1500)  # knife edges at sub-tile borders
    conic, radius = _conic_of(rng, n, 0.3, 2.0, aniso=3.0)
    k = rng.integers(1, hw // 16, size=(n, 2)) * 16   # a sub-tile's first pixel
    d = rng.uniform(0.5, 2.0, size=(n, 2))
    before = rng.uniform(size=(n, 2)) < 0.5           # outside its first / last
    centre = np.where(before, k - d, k - 1 + d)
    near = np.where(before, k, k - 1).astype(np.float64)
    free = rng.uniform(0, hw - 1, size=(n, 2))
    kind = rng.integers(0, 3, n)                      # x edge, y edge, corner
    use_x, use_y = kind != 1, kind != 0
    xy = np.stack([np.where(use_x, centre[:, 0], free[:, 0]),
                   np.where(use_y, centre[:, 1], free[:, 1])], -1)
    px = np.stack([np.where(use_x, near[:, 0], np.round(xy[:, 0])),
                   np.where(use_y, near[:, 1], np.round(xy[:, 1]))], -1)
    dx, dy = px[:, 0] - xy[:, 0], px[:, 1] - xy[:, 1]
    q = 0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy) + conic[:, 1] * dx * dy
    opa = np.minimum(np.exp(q) / 255.0 * (1.0 + rng.uniform(-1e-3, 1e-3, n)), 1.0)
    parts.append((xy, conic, radius, opa, rng.uniform(1.0, 5.0, n)))

    n = size(300)  # opacities at and above 1/255
    conic, radius = _conic_of(rng, n, 1.0, 4.0, aniso=2.0)
    t = np.float32(1.0 / 255.0)
    levels = np.asarray([t, np.nextafter(t, np.float32(1)), t * (1 + 1e-6),
                         t * (1 + 1e-4), t * 1.01], np.float64)
    parts.append((rng.uniform(0, hw, (n, 2)), conic, radius,
                  levels[rng.integers(0, len(levels), n)], rng.uniform(1.0, 5.0, n)))

    n = size(300)  # near-singular: long thin lines
    th = rng.uniform(0, np.pi, n)
    lmaj = np.exp(rng.uniform(np.log(1e3), np.log(1e7), n))
    co, si = np.cos(th), np.sin(th)
    ca, cb = co * co * lmaj + si * si * 0.3, co * si * (lmaj - 0.3)
    cc = si * si * lmaj + co * co * 0.3
    det = ca * cc - cb * cb
    conic = np.stack([cc / det, -cb / det, ca / det], -1)
    parts.append((rng.uniform(0, hw, (n, 2)), conic, np.full(n, float(hw)),
                  rng.uniform(0.05, 1.0, n), rng.uniform(1.0, 5.0, n)))

    n = size(200)  # near-isotropic conics
    a = rng.uniform(0.05, 1.0, n)
    conic = np.stack([a * (1 + rng.uniform(-1e-6, 1e-6, n)),
                      a * rng.uniform(-1e-6, 1e-6, n), a], -1)
    parts.append((rng.uniform(0, hw, (n, 2)), conic,
                  np.ceil(3.0 / np.sqrt(a)), rng.uniform(0.05, 1.0, n),
                  rng.uniform(1.0, 5.0, n)))

    n = size(20)  # not positive definite
    a = rng.uniform(0.2, 1.0, n)
    conic = np.stack([a, a * rng.uniform(1.0, 1.5, n), a], -1)
    parts.append((rng.uniform(0, hw, (n, 2)), conic, np.full(n, 4.0),
                  rng.uniform(0.05, 0.5, n), rng.uniform(1.0, 5.0, n)))

    f = lambda x: torch.as_tensor(np.concatenate(x).astype(np.float32), device=dev)
    xy, conic, radius, opa, depth = (f([p[i] for p in parts]) for i in range(5))
    n = xy.shape[0]
    color = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
    proj = ProjectedGaussians(xy=xy, depth=depth, conic=conic, color=color,
                              opacity=opa, radius=radius,
                              valid=torch.ones(n, dtype=torch.bool, device=dev))
    every_tile = (-(-hw // tile_size)) ** 2
    args, overflow, back = projected_inputs(proj, hw, hw, tile_size, every_tile,
                                            4096)
    invalid = torch.as_tensor(rng.uniform(size=n) < 0.03, device=dev)
    args[0][invalid, 10] = 0.0
    return args, overflow, back


def _ulps(x, k):
    """``x`` (float32 array) moved by ``k`` (int array) float32 ulps."""
    x = np.asarray(x, np.float32).copy()
    k = np.asarray(k)
    for step in range(int(np.abs(k).max(initial=0))):
        move = np.abs(k) > step
        x[move] = np.nextafter(x[move], np.where(k[move] > 0, np.inf, -np.inf)
                               .astype(np.float32))
    return x


def surfel_adversarial_scene(dev, tile_size=32, seed=0, hw=256):
    """The screen-circle skip's adversarial surfel scene at ``hw``²
    (seeded), as the kernels' inputs and a ``SurfelInputs`` record.  Real
    surfels (``_surfel_setup`` / ``_surfel_coeffs`` of points unprojected
    from the chosen screen centres) with, in the table, these centres and
    radii:

    - opaque surfels facing the camera (opacity 0.95-1) in front over the
      left half, with more than a staging batch of others behind them, so
      that pixels, sub-tiles and tiles stop early;
    - circles grazing a 16 px sub-tile's rectangle of pixel centres: the
      centre 1-4 px beyond an edge with that integer radius, or beyond a
      corner at offsets (3, 4) / (4, 3) with radius 5 and (1, 1) with
      radius f32(√2), each centre moved by -3..3 float32 ulps, so that the
      circle test passes or fails at the nearest pixel by a few ulps;
    - radius 0 and 1 with centres exactly on pixel centres, half of them on
      a sub-tile's edge pixels;
    - surfels seen edge-on (normal across the view rays, cr_z near 0 at
      some pixels: the depth pole);
    - rows made non-finite after binning: centre x NaN, centre y +inf,
      radius NaN, radius +inf (the kernels keep such slots; none makes an
      output non-finite).

    Binned with ``max_tiles`` = every tile of the view and a binning radius
    2 px above the table's, so nothing overflows and every tile a circle
    reaches holds it; the counts are those of a 256² view scaled to
    ``hw``²."""
    rng = np.random.default_rng(seed)
    size = lambda n: max(1, round(n * hw * hw / 256 ** 2))
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, hw, hw, znear=0.2, zfar=4.0)
    fx, fy = float(cam.focal_x), float(cam.focal_y)
    ident = np.tile(np.asarray([1.0, 0.0, 0.0, 0.0]), (1, 1))
    parts = []   # (xy, rad, depth, opacity, screen sigma px, quats)

    def facing(n):   # quaternions near the identity: the normal along the view
        q = ident + rng.normal(size=(n, 4)) * 0.15
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    n = size(500)   # opaque, in front, left half
    sig = rng.uniform(3.0, 6.0, n)
    parts.append((np.stack([rng.uniform(0, hw / 2, n), rng.uniform(0, hw, n)], -1),
                  np.ceil(3.0 * sig + 4.3), rng.uniform(1.0, 1.2, n),
                  rng.uniform(0.95, 1.0, n), sig, facing(n)))
    n = size(2500)  # behind them: more than a batch per tile
    sig = rng.uniform(3.0, 6.0, n)
    parts.append((np.stack([rng.uniform(0, hw / 2, n), rng.uniform(0, hw, n)], -1),
                  np.ceil(3.0 * sig + 4.3), rng.uniform(2.0, 2.5, n),
                  rng.uniform(0.2, 0.9, n), sig, facing(n)))

    n = size(1500)  # grazing circles
    sub = hw // 16
    x0 = rng.integers(0, sub, n) * 16.0
    y0 = rng.integers(0, sub, n) * 16.0
    kind = rng.integers(0, 4, n)          # x edge, y edge, corner 3-4-5, corner √2
    r = rng.integers(1, 5, n).astype(np.float64)
    side = rng.integers(0, 2, (n, 2))     # before the first / after the last pixel
    along = rng.integers(0, 16, (n, 2)).astype(np.float64)
    tri = np.where(rng.integers(0, 2, n)[:, None] == 0, [3.0, 4.0], [4.0, 3.0])
    off = np.where(kind[:, None] == 2, tri, 1.0)
    off = np.where(kind[:, None] == 0, np.stack([r, np.zeros(n)], -1), off)
    off = np.where(kind[:, None] == 1, np.stack([np.zeros(n), r], -1), off)
    rad = np.where(kind == 2, 5.0, np.where(kind == 3, np.float32(np.sqrt(2.0)), r))
    lo = np.stack([x0, y0], -1)
    edge = np.where(side == 0, lo - off, lo + 15.0 + off)
    inside = lo + along                   # the free coordinate of an edge
    xy = np.stack([np.where(kind == 1, inside[:, 0], edge[:, 0]),
                   np.where(kind == 0, inside[:, 1], edge[:, 1])], -1)
    xy = np.stack([_ulps(xy[:, 0], rng.integers(-3, 4, n)),
                   _ulps(xy[:, 1], rng.integers(-3, 4, n))], -1)
    sig = rng.uniform(1.0, 2.0, n) * np.maximum(rad, 1.0)
    parts.append((xy, rad, rng.uniform(1.3, 1.9, n), rng.uniform(0.6, 1.0, n), sig,
                  facing(n)))

    n = size(300)   # radius 0 and 1 on pixel centres, half on sub-tile edges
    px = rng.integers(0, hw, (n, 2)).astype(np.float64)
    on_edge = rng.uniform(size=(n, 2)) < 0.5
    px = np.where(on_edge, np.floor(px / 16) * 16 + np.where(
        rng.uniform(size=(n, 2)) < 0.5, 0.0, 15.0), px)
    parts.append((px, rng.integers(0, 2, n).astype(np.float64),
                  rng.uniform(1.3, 1.9, n), rng.uniform(0.5, 1.0, n),
                  rng.uniform(1.0, 3.0, n), facing(n)))

    n = size(300)   # edge-on: the normal across the view rays
    half = np.pi / 4
    q = np.stack([np.full(n, np.cos(half)), np.zeros(n), np.full(n, np.sin(half)),
                  np.zeros(n)], -1) + rng.normal(size=(n, 4)) * 0.02
    sig = rng.uniform(4.0, 10.0, n)
    parts.append((rng.uniform(0, hw, (n, 2)), np.ceil(3.0 * sig + 4.3),
                  rng.uniform(1.3, 1.9, n), rng.uniform(0.5, 1.0, n), sig,
                  q / np.linalg.norm(q, axis=1, keepdims=True)))

    n = size(60)    # made non-finite after binning
    sig = rng.uniform(2.0, 4.0, n)
    parts.append((rng.uniform(0, hw, (n, 2)), np.ceil(3.0 * sig + 4.3),
                  rng.uniform(1.3, 1.9, n), rng.uniform(0.5, 1.0, n), sig,
                  facing(n)))
    n_bad = n

    xy, rad, depth, opa, sig, quats = (np.concatenate([p[i] for p in parts])
                                      for i in range(6))
    n = xy.shape[0]
    cxy = np.asarray([(hw - 1) / 2.0, (hw - 1) / 2.0])
    view = np.concatenate([(xy - cxy) * depth[:, None] / np.asarray([fx, fy]),
                           depth[:, None]], -1)
    means = view + c2w[:3, 3]
    scales = np.repeat((sig * depth / fx)[:, None], 2, axis=1)
    shs = rng.normal(size=(n, 4, 3)) * 0.3 + 0.2
    M, normal, _, _, color, _, _ = _surfel_setup(
        f(means), f(scales), f(quats), f(opa), f(shs), cam, 1)
    acr, bcr, ccr, det = _surfel_coeffs(M)
    xy_t, rad_t, opa_t = f(xy), f(rad), f(opa)

    # binning: surfel_inputs' isotropic conic at a radius 2 px above the table's
    rad_bin = rad_t + 2.0
    tau = torch.log(torch.clamp(opa_t, min=1e-12) * 255.0)
    lam = 2.0 * torch.clamp(tau, min=1e-6) / rad_bin ** 2
    proj = ProjectedGaussians(xy=xy_t, depth=f(depth),
                              conic=torch.stack([lam, torch.zeros_like(lam), lam], -1),
                              color=color, opacity=opa_t, radius=rad_bin,
                              valid=torch.ones(n, dtype=torch.bool, device=dev))
    every_tile = (-(-hw // tile_size)) ** 2
    bins = bin_gaussians(proj, hw, hw, tile_size=tile_size, max_tiles=every_tile)
    counts = torch.clamp(bins.tile_counts, max=4096)
    overflow = bins.overflow + (bins.tile_counts - counts).sum().to(torch.int32)

    table = pack_surfel_table(acr, bcr, ccr, det, xy_t, rad_t, color, opa_t, normal)
    bad = torch.arange(n - n_bad, n, device=dev)
    nan, inf = float("nan"), float("inf")
    for i, (col, v) in enumerate(((10, nan), (11, inf), (19, nan), (19, inf))):
        table[bad[i::4], col] = v
    planes = torch.stack([cam.znear, cam.zfar]).to(dtype=torch.float32)
    si = SurfelInputs(
        attrs=(acr, bcr, ccr, det, xy_t, rad_t, color, opa_t, normal), planes=planes,
        bins=(bins.sorted_ids, bins.sorted_o, bins.depth_order, bins.tile_starts,
              counts),
        dims=(bins.tiles_x, bins.tiles_y, tile_size), n_slots=n * every_tile,
        radius=rad_t, overflow=overflow)
    return (table, bins.sorted_ids, bins.tile_starts, counts, planes,
            *si.dims), si

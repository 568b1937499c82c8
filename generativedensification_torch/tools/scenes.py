"""The seeded scenes on which the compositor kernels are measured, as the
kernels' own inputs (projected or set up, binned and packed by the port).

- scene A: ``bench.py``'s scene (512², 131,072 Gaussians from seed 0),
  ``bench_scene``; its surfel form A′ (``scripts/dev_surfel_break.py``: 2-D
  scales in [0.002, 0.01], or [0.004, 0.02] with ``scales="free"``),
  ``surfel_bench_scene``;
- scene B / B′: the 262,144 coarse Gaussians / surfels of the full-width
  serving network from seed 0 on the probe batch, in view 0
  (``model_view`` and ``model_gaussians`` / ``model_surfels``);
- a small surfel scene (256², 20,000 surfels), ``surfel_scene``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_infer_config
from ..core.camera import Camera
from ..core.transforms import normalize_quat
from ..splat.binning import bin_gaussians
from ..splat.composite import pack_table
from ..splat.projection import project_gaussians
from ..splat.surfel import pack_surfel_table, surfel_inputs


def fine_config(**over):
    """The serving configuration: the infer defaults (``mask_pool`` 262144)
    in f32, built without PyYAML."""
    cfg = default_infer_config()
    cfg.set_dotted("tpu.compute_dtype", "float32")
    for k, v in over.items():
        cfg.set_dotted(k, v)
    return cfg


def compositor_inputs(means, shs, opa, scales, quats, cam, tile_size,
                      max_tiles, max_per_tile):
    """Project + bin one view with the port's own functions.  Returns the
    forward kernel's arguments, the pairs the budgets dropped, and the
    ``bins`` that ``composite.composite_backward`` takes."""
    proj = project_gaussians(means, shs, opa, cam, 1, scales,
                             normalize_quat(quats))
    bins = bin_gaussians(proj, cam.height, cam.width, tile_size=tile_size,
                         max_tiles=max_tiles)
    opa_eff = torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))
    table = pack_table(proj.xy, proj.conic, proj.color, opa_eff, proj.depth,
                       proj.valid)
    counts = torch.clamp(bins.tile_counts, max=min(max_per_tile,
                                                   means.shape[0] * max_tiles))
    overflow = int(bins.overflow) + int((bins.tile_counts - counts).sum())
    args = (table, bins.sorted_ids, bins.tile_starts, counts, bins.tiles_x,
            bins.tiles_y, tile_size)
    back = (bins.sorted_ids, bins.sorted_o, bins.depth_order, bins.tile_starts,
            counts, means.shape[0] * max_tiles)
    return args, overflow, back


def surfel_kernel_inputs(means, shs, opa, scales2d, quats, cam, tile_size,
                         max_tiles, max_per_tile):
    """Set up and bin one view's surfels with the port's own functions (the
    part of ``rasterize_surfels`` before compositing); returns the kernels'
    inputs and the ``SurfelInputs`` record."""
    si = surfel_inputs(means, shs, opa, scales2d, quats, cam, 1, tile_size,
                       max_tiles, max_per_tile)
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


def bench_scene(dev, tile_size=32, max_tiles=4, n=131072, hw=512):
    """Scene A: ``bench.py``'s scene (512², 131,072 Gaussians, seed 0), at
    its tile size and ``max_tiles``; ``compositor_inputs``' three values."""
    means, shs, opa, scales, quats, cam = _bench_arrays(dev, n, hw, 3)
    return compositor_inputs(means, shs, opa, scales, quats, cam, tile_size,
                             max_tiles, 4096)


def surfel_bench_scene(dev, scales="default", tile_size=32, max_tiles=4,
                       n=131072, hw=512):
    """Scene A′: the surfel form of scene A (``scripts/dev_surfel_break.py``),
    2-D scales in [0.002, 0.01], or [0.004, 0.02] with ``scales="free"``."""
    smin, smax = (0.004, 0.02) if scales == "free" else (0.002, 0.01)
    means, shs, opa, s2, quats, cam = _bench_arrays(dev, n, hw, 2, smin, smax)
    return surfel_kernel_inputs(means, shs, opa, s2, normalize_quat(quats), cam,
                                tile_size, max_tiles, 4096)


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


def model_gaussians(pkg, cam, cfg, tile_size=None, max_tiles=None):
    """Scene B: a forward's coarse Gaussians ``pkg`` (``render_pkg[0]``) of
    batch element 0 in camera ``cam``, binned with the configuration's
    budgets (or the given tile size and ``max_tiles``);
    ``compositor_inputs``' three values."""
    centers, shs, opacity, scaling, rotation = pkg
    return compositor_inputs(
        centers[0], shs[0], torch.sigmoid(opacity[0, :, 0]), torch.exp(scaling[0]),
        rotation[0], cam, tile_size or cfg.tile_size, max_tiles or cfg.max_tiles,
        cfg.max_per_tile)


def model_surfels(pkg, cam, cfg, tile_size=None, max_tiles=None):
    """Scene B′: as ``model_gaussians`` for the coarse surfels of a 2DGS
    forward; ``surfel_kernel_inputs``' two values."""
    centers, shs, opacity, scaling, rotation = pkg
    return surfel_kernel_inputs(
        centers[0], shs[0], torch.sigmoid(opacity[0, :, 0]),
        torch.exp(scaling[0])[:, :2], rotation[0], cam,
        tile_size or cfg.tile_size, max_tiles or cfg.max_tiles, cfg.max_per_tile)

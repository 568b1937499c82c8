"""PyTorch port vs the JAX package: the 2DGS surfel rasterizer.

The geometry (``_surfel_setup``, ``_surfel_coeffs``, ``depth_to_normal``),
``rasterize_surfels`` with and without the fused AbsGS selection, and
``composite_surfels_backward(mode="full")`` against ``jax.vjp`` of
``composite_surfels``, all on JAX's XLA backend, its semantic ground truth.
On the CPU the port composites through the kernels' plain versions
(``tests/test_torch_kernels.py`` holds the CUDA kernels against them on the
card).

The tolerances are the JAX package's own contract between its two surfel
backends, which is looser than its 3DGS contract: maps within 5e-4 after
scaling by max(1, max |map|) and the median depth within 1e-3 where both
crossed, with under 1% of pixels crossing on one side only
(``tests/test_pallas_surfel.py:50-66``); gradients within 2e-3 scaled
(``:94-98``); ``sel_abs`` within 1e-4 scaled (``tests/test_surfel.py:262-
266``).  The port's kernels share the serial chain of the Pallas kernels (a
pixel stops for good at T < 1e-4) and their closed-form distortion, where the
XLA scan carries T·Π(1 − α·include) across its chunks and sums the
distortion incrementally; the two forms meet only to rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core.camera import Camera as JCamera
from generativedensification_tpu.core.rays import camera_rays as j_camera_rays
from generativedensification_tpu.splat import surfel as jsur
from generativedensification_torch.core.camera import Camera as TCamera
from generativedensification_torch.core.rays import camera_rays as t_camera_rays
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat import surfel as tsur
from generativedensification_torch.splat.binning import bin_gaussians
from generativedensification_torch.splat.projection import ProjectedGaussians

torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a))
MAP_ATOL = 5e-4      # surfel maps, scaled by max(1, max |map|)
GRAD_ATOL = 2e-3     # surfel gradients, scaled by their max |value|
SEL_ATOL = 1e-4      # sel_abs, scaled by its max
H = W = 64
N = 64


def _scene(seed=0, n=N, hw=H, spread=0.35, scale=(0.05, 0.15), opa=None,
           c2w_z=-1.6, znear=0.2, zfar=4.0):
    """``tests/test_pallas_surfel.py::_scene`` (same generator calls) as
    numpy arrays and the two cameras."""
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    means = f(rng.uniform(-spread, spread, (n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    o = f(rng.normal(size=(n,))) if opa is None else f(rng.uniform(*opa, n))
    if opa is None:
        o = f(1.0 / (1.0 + np.exp(-o.astype(np.float64))))
    scales = f(np.exp(rng.uniform(np.log(scale[0]), np.log(scale[1]), (n, 2))))
    quats = f(rng.normal(size=(n, 4)))
    quats = f(quats / np.linalg.norm(quats, axis=-1, keepdims=True))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = c2w_z
    jc = JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, hw, hw, znear=znear, zfar=zfar)
    tc = TCamera.from_c2w(T(c2w), 0.8, 0.8, hw, hw, znear=znear, zfar=zfar)
    bg = f([0.2, 0.5, 0.8])
    return (means, shs, o, scales, quats), jc, tc, bg


def _both(arrays, jc, tc, bg, sel_gt=None, **kw):
    jo = jsur.rasterize_surfels(*map(jnp.asarray, arrays), jc, jnp.asarray(bg),
                                sh_degree=1, backend="xla", chunk=32,
                                sel_gt=None if sel_gt is None else jnp.asarray(sel_gt),
                                **kw)
    with torch.inference_mode():
        to = tsur.rasterize_surfels(*map(T, arrays), tc, T(bg), 1,
                                    sel_gt=None if sel_gt is None else T(sel_gt), **kw)
    return jo, to


def _maps_close(jo, to):
    for name in ("image", "alpha", "depth_expected", "normal", "dist"):
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b / scale, a / scale, atol=MAP_ATOL, rtol=0,
                                   err_msg=name)
    dm_j, dm_t = np.asarray(jo.depth_median), to.depth_median.numpy()
    assert ((dm_j > 0) != (dm_t > 0)).mean() < 0.01
    both = (dm_j > 0) & (dm_t > 0)
    assert both.any()
    np.testing.assert_allclose(dm_t[both], dm_j[both], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(np.asarray(jo.radii), to.radii.numpy())
    assert int(jo.overflow) == int(to.overflow)


def _scaled_close(a, b, atol, name):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(1e-8, float(np.abs(a).max()))
    np.testing.assert_allclose(b / scale, a / scale, atol=atol, rtol=0,
                               err_msg=name)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


def test_surfel_setup_and_coeffs_match_jax():
    arrays, jc, tc, _ = _scene(seed=2, n=200, spread=1.6)
    means, shs, opa, scales, quats = arrays
    jout = jsur._surfel_setup(jnp.asarray(means), jnp.asarray(scales),
                              jnp.asarray(quats), jnp.asarray(opa),
                              jnp.asarray(shs), jc, 1)
    tout = tsur._surfel_setup(T(means), T(scales), T(quats), T(opa), T(shs), tc, 1)
    names = ["M", "n_view", "xy", "depth", "color", "radius", "valid"]
    for a, b, name in zip(jout, tout, names):
        a = np.asarray(a)
        if name in ("radius", "valid"):
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        else:
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    valid = np.asarray(jout[6])
    assert 0 < valid.sum() < valid.size      # both branches of the cull
    jc_ = jsur._surfel_coeffs(jout[0])
    tc_ = tsur._surfel_coeffs(T(np.asarray(jout[0])))
    for a, b, name in zip(jc_, tc_, ["acr", "bcr", "ccr", "det"]):
        a = np.asarray(a)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=1e-5,
                                   rtol=0, err_msg=name)


def test_depth_to_normal_matches_jax():
    _, jc, tc, _ = _scene()
    rng = np.random.default_rng(3)
    depth = (1.5 + 0.2 * rng.uniform(size=(H, W))).astype(np.float32)
    alpha = rng.uniform(size=(H, W)).astype(np.float32)
    a = jsur.depth_to_normal(jnp.asarray(depth), j_camera_rays(jc), jnp.asarray(alpha))
    b = tsur.depth_to_normal(T(depth), t_camera_rays(tc), T(alpha))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    assert float(np.abs(np.asarray(a)).max()) > 0.5


# --------------------------------------------------------------------------
# the rasterizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [16, 32])
def test_rasterize_surfels_matches_jax(ts):
    """The JAX backend-parity scene (64², N = 64): every map at 5e-4
    scaled, the median-depth rule, radii and overflow equal."""
    arrays, jc, tc, bg = _scene()
    jo, to = _both(arrays, jc, tc, bg, tile_size=ts, max_tiles=16,
                   max_per_tile=256, enum_tiles=16)
    assert float(to.alpha.max()) > 0.5
    _maps_close(jo, to)


def test_rasterize_surfels_capped_tiles_match_jax():
    """16 px tiles against a 32-slot cap: the clamp engages (overflow > 0)
    and both sides composite the same front-most slots."""
    arrays, jc, tc, bg = _scene(seed=9)
    jo, to = _both(arrays, jc, tc, bg, tile_size=16, max_tiles=16,
                   max_per_tile=32, enum_tiles=16)
    assert int(to.overflow) > 0
    _maps_close(jo, to)


@pytest.mark.parametrize("max_per_tile", [64, 32])
def test_sel_abs_matches_jax(max_per_tile):
    """``rasterize_surfels(sel_gt=...)`` on ``tests/test_surfel.py``'s
    selection scene (32², N = 40), uncapped and capped: sel_abs at 1e-4
    scaled, the shared forward unchanged by the selection pass."""
    arrays, jc, tc, bg = _scene(seed=8, n=40, hw=32, spread=0.3,
                                scale=(0.08, 0.2), opa=(0.3, 0.8))
    gt = np.random.default_rng(8).uniform(size=(32, 32, 3)).astype(np.float32)
    kw = dict(tile_size=16, max_tiles=4, max_per_tile=max_per_tile, enum_tiles=4)
    jo, to = _both(arrays, jc, tc, bg, sel_gt=gt, **kw)
    if max_per_tile == 32:
        assert int(to.overflow) > 0
    assert to.sel_abs.shape == (40, 2) and float(to.sel_abs.max()) > 0
    _scaled_close(jo.sel_abs, to.sel_abs, SEL_ATOL, "sel_abs")
    _, plain = _both(arrays, jc, tc, bg, **kw)
    torch.testing.assert_close(to.image, plain.image, rtol=0, atol=0)
    _maps_close(jo, to)


# --------------------------------------------------------------------------
# the compositing backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [16, 32])
def test_composite_surfels_backward_matches_jax(ts):
    """``composite_surfels_backward(mode="full")``: every attribute gradient
    and d_bg against ``jax.vjp`` of the JAX ``composite_surfels`` (XLA
    backend) with seeded cotangents on all six outputs, 2e-3 scaled."""
    arrays, jc, tc, bg = _scene(seed=4)
    means, shs, opa, scales, quats = arrays
    M, n_view, xy, depth, color, radius, valid = jsur._surfel_setup(
        *(jnp.asarray(a) for a in (means, scales, quats, opa, shs)), jc, 1)
    acr, bcr, ccr, det = jsur._surfel_coeffs(M)
    opa_eff = jnp.where(valid, jnp.asarray(opa), 0.0)
    lam = 2.0 * jnp.maximum(jnp.log(jnp.maximum(jnp.asarray(opa), 1e-12) * 255.0),
                            1e-6) / jnp.maximum(radius, 1.0) ** 2
    # bin once, with the port (the JAX binning gives the same arrays,
    # tests/test_torch_splat.py), and hand the same segments to both sides
    proj = ProjectedGaussians(
        xy=T(xy), depth=T(depth), conic=T(jnp.stack([lam, 0 * lam, lam], -1)),
        color=T(color), opacity=T(opa), radius=T(radius), valid=T(valid))
    bins = bin_gaussians(proj, H, W, tile_size=ts, max_tiles=16, enum_tiles=16)
    counts = torch.clamp(bins.tile_counts, max=256)
    jbins = tuple(jnp.asarray(b.numpy()) for b in (
        bins.sorted_ids, bins.sorted_o, bins.sorted_valid, bins.sorted_rank,
        bins.depth_order, bins.tile_starts, counts))
    tx, ty = bins.tiles_x, bins.tiles_y
    rng = np.random.default_rng(1)
    hp, wp = ty * ts, tx * ts
    cot = (rng.normal(size=(hp, wp, 3)), 0.3 * rng.normal(size=(hp, wp)),
           0.1 * rng.normal(size=(hp, wp)), 0.2 * rng.normal(size=(hp, wp)),
           0.2 * rng.normal(size=(hp, wp, 3)), 50.0 * rng.normal(size=(hp, wp)))
    cot = tuple(np.asarray(c, np.float32) for c in cot)
    znear, zfar = jnp.float32(0.2), jnp.float32(4.0)
    args = (acr, bcr, ccr, det, xy, radius, color, opa_eff, n_view, jnp.asarray(bg))

    def f(*a):
        return jsur.composite_surfels(*a, znear, zfar, jbins, tx, ty, ts, 256, 32,
                                      "xla")

    jout, vjp = jax.vjp(f, *args)
    jg = vjp(tuple(jnp.asarray(c) for c in cot))

    t_args = [T(a) for a in args]
    table = tsur.pack_surfel_table(*t_args[:5], t_args[5], t_args[6], t_args[7],
                                   t_args[8])
    planes = torch.tensor([0.2, 4.0])
    bins_t = (bins.sorted_ids, bins.sorted_o, bins.tile_starts, counts)
    with torch.inference_mode():
        out = tsur.surfel_fwd(table, bins.sorted_ids, bins.tile_starts, counts,
                              planes, tx, ty, ts)
        maps = tsur._maps(out, T(bg), tx, ty, ts)
        grads, sel = tsur.composite_surfels_backward(
            table, out, T(bg), tuple(map(T, cot)), planes, bins_t, (tx, ty, ts),
            N * 16, "full")
    assert sel is None
    for a, b, name in zip(jout, maps, ["image", "alpha", "dexp", "dmed", "normal",
                                       "dist"]):
        if name != "dmed":
            scale = max(1.0, float(np.abs(np.asarray(a)).max()))
            np.testing.assert_allclose(b.numpy() / scale, np.asarray(a) / scale,
                                       atol=MAP_ATOL, rtol=0, err_msg=name)
    # JAX's order: acr, bcr, ccr, det, xy, rad, color, opacity, normal, bg
    j_by_name = dict(zip(["acr", "bcr", "ccr", "det", "xy", "rad", "color",
                          "opacity", "normal", "bg"], jg))
    names = ["acr", "bcr", "ccr", "det", "xy", "color", "opacity", "normal", "bg"]
    for name, b in zip(names, grads):
        assert float(np.abs(np.asarray(j_by_name[name])).max()) > 0, name
        _scaled_close(j_by_name[name], b, GRAD_ATOL, f"d_{name}")


def test_renderer2dgs_keys_and_device_rule():
    arrays, jc, tc, bg = _scene()
    means, shs, opa, scales, quats = map(T, arrays)
    r = tsur.Renderer2DGS(device="cpu")
    out = r.render_img(tc, t_camera_rays(tc), means, shs, opa,
                       torch.cat([scales, torch.full((N, 1), 0.01)], -1), quats,
                       tile_size=16, max_tiles=16, enum_tiles=16, prex="_fine")
    assert set(out) == {f"{k}_fine" for k in ("image", "depth", "acc_map",
                                                "rend_dist", "rend_normal", "radii",
                                                "depth_normal")}
    assert kernels.launch_counts["surfel_fwd"] == 0     # CPU: no launch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsur.Renderer2DGS()

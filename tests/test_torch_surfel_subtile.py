"""The surfel compositors' screen-circle skip on the CPU:
``surfel_kernels.subtile_touch`` (the PyTorch mirror of the CUDA kernels'
per-sub-tile predicate) is conservative, the plain versions with the skip
are bitwise the plain versions without it (forward and both backward modes,
16 and 32 px tiles, with pixels and tiles that stop early), and the
skip-mirrored plain forward agrees with the JAX package's Pallas surfel
compositor.  Seeded numpy / port scenes at 64²-256²."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core.camera import Camera as JCamera
from generativedensification_tpu.splat import surfel as jsur
from generativedensification_tpu.splat.binning import bin_gaussians
from generativedensification_tpu.splat.projection import ProjectedGaussians
from generativedensification_torch.splat import surfel as tsur
from generativedensification_torch.splat import surfel_kernels as sk
from generativedensification_torch.splat.composite import mse_image_cotangent
from generativedensification_torch.tools import scenes

torch.set_num_threads(1)

MAP_ATOL = 5e-4      # the JAX surfel contract: maps scaled by max(1, max |map|)
SUB = 16
f32 = np.float32


def _scene(name, ts, hw=256):
    if name == "adversarial":
        return scenes.surfel_adversarial_scene("cpu", ts, hw=hw)
    # scene A′'s distributions, 3,000 surfels per 256², every rect tile
    # enumerated
    return scenes.surfel_bench_scene("cpu", "free", ts, 16,
                                     n=3000 * hw * hw // 256 ** 2, hw=hw,
                                     enum_tiles=16)


def _segments(args):
    """Every in-segment slot, its tile, and its row's centre and radius."""
    table, ids, starts, counts, planes, tx, ty, ts = args
    counts = counts.long()
    tile = torch.repeat_interleave(torch.arange(tx * ty), counts)
    rank = torch.arange(tile.shape[0]) - (torch.cumsum(counts, 0) - counts)[tile]
    slot = starts.long()[tile] + rank
    rows = table[ids[slot].long()]
    return slot, tile, rows[:, sk.PX], rows[:, sk.PY], rows[:, sk.RAD]


def _reach(args):
    """(sub-tiles, P) each: whether the slot lies in its tile's segment,
    whether some pixel of the sub-tile passes its circle test (in the plain
    forward's f32 operations), and the least d² − rad² over the sub-tile's
    pixels relative to rad² (finite rows only)."""
    ts, tx = args[7], args[5]
    side = ts // SUB
    slot, tile, px, py, rad = _segments(args)
    rad2 = rad * rad
    shape = (side * side, args[1].shape[0])
    in_seg = torch.zeros(shape, dtype=torch.bool)
    passes = torch.zeros(shape, dtype=torch.bool)
    gap = torch.full(shape, float("inf"))
    lin = torch.arange(SUB, dtype=torch.float32)
    finite = torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(rad)
    for q in range(side * side):
        x0 = ((tile % tx) * ts + (q % side) * SUB).float()
        y0 = (torch.div(tile, tx, rounding_mode="floor") * ts + (q // side) * SUB).float()
        hit = torch.zeros(slot.shape, dtype=torch.bool)
        best = torch.full(slot.shape, float("inf"))
        for row in range(SUB):
            dx = (x0[:, None] + lin) - px[:, None]
            dy = (y0 + row) - py
            d2 = dx * dx + (dy * dy)[:, None]
            hit |= (d2 <= rad2[:, None]).any(1)
            best = torch.fmin(best, d2.amin(1))
        in_seg[q, slot] = True
        passes[q, slot] = hit
        gap[q, slot] = torch.where(finite, (best - rad2) / torch.clamp(rad2, min=1e-30),
                                   torch.full_like(best, float("inf")))
    return in_seg, passes, gap


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("name", ["bench", "adversarial"])
def test_touch_is_conservative(name, ts):
    """Every (slot, sub-tile) pair the skip drops fails the circle test at
    every pixel of the sub-tile; the skip drops a real share of the pairs
    (at 32 px tiles, where the sub-tile is a quarter of the binned tile);
    on the adversarial scene some dropped pairs miss by less than 1e-4 of
    rad², and some kept pairs pass at exactly d² = rad²."""
    args, si = _scene(name, ts)
    assert int(si.overflow) == 0
    touch = sk.subtile_touch(*args[:4], *args[5:])
    in_seg, passes, gap = _reach(args)
    assert torch.equal(touch & ~in_seg, torch.zeros_like(touch))
    dropped = in_seg & ~touch
    assert not bool((dropped & passes).any())
    kept_share = float(touch.sum()) / float(in_seg.sum())
    if ts == 32:
        assert kept_share < 0.75, kept_share
    if name == "adversarial":
        assert float(gap[dropped].min()) < 1e-4
        assert bool(((gap == 0) & passes & touch).any())


def test_keep_rules():
    """The predicate's rules on hand-made slots against the sub-tile with
    first pixel (16, 32): a centre inside keeps; a circle that reaches the
    nearest pixel centre exactly keeps (an edge at radius 1, a corner at
    (3, 4) / radius 5); one that misses by more than the margin drops;
    radius 0 keeps only a centre on a pixel of the sub-tile; a non-finite
    centre or radius keeps."""
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    inf, nan = float("inf"), float("nan")
    #          px       py      rad
    rows = f([20.5, 40.25, 0.0],          # inside: keep
             [15.0, 40.0, 1.0],           # 1 px left of the edge, radius 1: keep
             [15.0, 40.0, 0.999],         # radius just short: drop
             [32.0, 40.0, 1.0],           # 1 px right of the last column: keep
             [13.0, 28.0, 5.0],           # corner at (3, 4), radius 5: keep
             [13.0, 28.0, 4.999],         # drop
             [12.9, 28.0, 5.0],           # 3.1 px away in x: drop
             [16.0, 32.0, 0.0],           # radius 0 on the corner pixel: keep
             [15.0, 32.0, 0.0],           # radius 0 one pixel outside: drop
             [nan, 40.0, 1.0],            # non-finite: keep
             [100.0, inf, 1.0],
             [100.0, 100.0, nan],
             [100.0, 100.0, inf],
             [100.0, 100.0, 3.0])         # far: drop
    keep = sk.subtile_keep(*rows.unbind(1), 16.0, 32.0)
    assert keep.tolist() == [True, True, False, True, True, False, False, True,
                             False, True, True, True, True, False]


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("name", ["bench", "adversarial"])
def test_forward_with_touch_is_bitwise(name, ts):
    """``surfel_fwd_plain(touch=...)`` equals ``surfel_fwd_plain`` bit for
    bit and counts the circle tests the skip leaves (fewer at 32 px tiles);
    on the adversarial
    scene pixels saturate and the non-finite rows leave every output
    finite."""
    args, _ = _scene(name, ts, hw=192)
    touch = sk.subtile_touch(*args[:4], *args[5:])
    st_all, st_kept = {}, {}
    ref = sk.surfel_fwd_plain(*args, stats=st_all)
    out = sk.surfel_fwd_plain(*args, stats=st_kept, touch=touch)
    assert torch.equal(out, ref)
    for k in ("evals", "inside", "contribs"):
        assert st_kept[k] == st_all[k], k
    assert 0 < st_kept["evals_kept"] <= st_kept["evals"]
    if ts == 32:    # at 16 px the binning has already culled by the circle
        assert st_kept["evals_kept"] < st_kept["evals"]
    assert "evals_kept" not in st_all
    if name == "adversarial":
        assert bool(torch.isfinite(ref).all())
        assert float(ref[:, 12].min()) < 1e-3


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("name", ["bench", "adversarial"])
def test_backward_with_touch_is_bitwise(name, ts):
    """``surfel_bwd_plain(touch=...)`` equals ``surfel_bwd_plain`` bit for
    bit in both modes (128², the image-MSE cotangent of a seeded image and
    seeded cotangents on the other five maps)."""
    args, si = _scene(name, ts, hw=128)
    out = sk.surfel_fwd_plain(*args)
    bg = torch.ones(3)
    maps = tsur._maps(out, bg, *si.dims)
    rng = np.random.default_rng(3)
    f = lambda x: torch.as_tensor(np.asarray(x, f32))
    cot = (mse_image_cotangent(maps[0], f(rng.uniform(size=tuple(maps[0].shape)))),
           *(f(rng.normal(size=tuple(m.shape)) * 1e-4) for m in maps[1:]))
    touch = sk.subtile_touch(*args[:4], *args[5:])
    for mode in sk.SURFEL_BWD_ROWS:
        cot8, aux5, _ = tsur._bwd_rows(out, bg, cot, si.dims, mode)
        bargs = (*args[:5], cot8, aux5, *args[5:])
        ref = sk.surfel_bwd_plain(*bargs, mode=mode)
        got = sk.surfel_bwd_plain(*bargs, mode=mode, touch=touch)
        assert float(ref.abs().max()) > 0, mode
        assert bool(torch.isfinite(ref).all()), mode
        assert torch.equal(got, ref), mode


def test_skip_mirrored_forward_matches_jax_pallas(ts=32):
    """The plain forward with the skip against the JAX package's Pallas
    surfel compositor (interpret mode) on the same arrays, set up and
    binned by JAX (``tests/test_torch_probes.py``'s scene: 2,000 seeded
    surfels at 64², here at 32 px tiles, where a sub-tile is a quarter of
    the binned tile and the skip drops pairs the binning kept): every map within the JAX surfel contract, 5e-4 of
    max(1, max |map|); the median depth within 1e-3 where both crossed and
    under 1% one-sided."""
    hw, n = 64, 2000
    rng = np.random.default_rng(1)
    means = rng.uniform(-0.45, 0.45, size=(n, 3)).astype(f32)
    shs = (rng.normal(size=(n, 4, 3)) * 0.3 + 0.2).astype(f32)
    opa = (1.0 / (1.0 + np.exp(-(rng.normal(size=n) + 1.0)))).astype(f32)
    scales = (2.0 * np.exp(rng.uniform(np.log(0.004), np.log(0.02), (n, 2)))).astype(f32)
    quats = rng.normal(size=(n, 4)).astype(f32)
    c2w = np.eye(4, dtype=f32)
    c2w[2, 3] = -1.9
    cam = JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, hw, hw, znear=0.2, zfar=4.0)
    M, n_view, xy, depth, color, radius, valid = jsur._surfel_setup(
        *(jnp.asarray(a) for a in (means, scales, quats, opa, shs)), cam, 1)
    acr, bcr, ccr, det = jsur._surfel_coeffs(M)
    tau = jnp.log(jnp.maximum(jnp.asarray(opa), 1e-12) * 255.0)
    lam = 2.0 * jnp.maximum(tau, 1e-6) / jnp.maximum(radius, 1.0) ** 2
    proj = ProjectedGaussians(xy=xy, depth=depth,
                              conic=jnp.stack([lam, 0 * lam, lam], -1), color=color,
                              opacity=jnp.asarray(opa), radius=radius, valid=valid)
    bins = bin_gaussians(proj, hw, hw, tile_size=ts, max_tiles=9, enum_tiles=9)
    assert int(bins.overflow) == 0
    arrays = [np.asarray(a) for a in (acr, bcr, ccr, det, xy, radius, color)]
    arrays += [np.where(np.asarray(valid), opa, 0).astype(f32), np.asarray(n_view)]
    T = lambda a: torch.from_numpy(np.array(a))
    table = tsur.pack_surfel_table(*map(T, arrays))
    args = (table, T(bins.sorted_ids), T(bins.tile_starts), T(bins.tile_counts),
            T(np.asarray([0.2, 4.0], f32)), bins.tiles_x, bins.tiles_y, ts)
    touch = sk.subtile_touch(*args[:4], *args[5:])
    assert not bool(touch.all())
    out = sk.surfel_fwd_plain(*args, touch=touch)
    bg = np.asarray([0.2, 0.5, 0.8], f32)
    jb = (bins.sorted_ids, bins.sorted_o, bins.sorted_valid, bins.sorted_rank,
          bins.depth_order, bins.tile_starts, bins.tile_counts)
    jo = jsur.composite_surfels(*(jnp.asarray(a) for a in arrays), jnp.asarray(bg),
                                jnp.float32(0.2), jnp.float32(4.0), jb, bins.tiles_x,
                                bins.tiles_y, ts, 4096, 32, "pallas")
    to = tsur._maps(out, T(bg), bins.tiles_x, bins.tiles_y, ts)
    assert float(to[1].max()) > 0.5
    for a, b, name in zip(jo, to, ("image", "alpha", "dexp", "dmed", "normal", "dist")):
        a, b = np.asarray(a), b.numpy()
        if name == "dmed":
            assert ((a > 0) != (b > 0)).mean() < 0.01
            both = (a > 0) & (b > 0)
            assert both.any()
            np.testing.assert_allclose(b[both], a[both], atol=1e-3, rtol=0)
            continue
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b / scale, a / scale, atol=MAP_ATOL, rtol=0,
                                   err_msg=name)

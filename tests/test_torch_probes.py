"""The stage probes of the two forward compositors (``splat/probe_kernels.py``)
on the CPU, where every variant takes its plain version.

Each scene is projected (3DGS) or set up (surfels) and binned by the JAX
package; the port's probes composite the same arrays.  Every stripped
stage's plain output is held against an independent numpy computation from
those arrays: the per-(slot, pixel) quantities in float32 in the kernels'
order over the slots that the skip keeps for the pixel's 16 x 16 sub-tile
(``subtile_touch``), the stage's sums in float64, within 1e-5 of Σ|terms|
per pixel (the port adds serially in f32), each sub-tile CTA's thread t at
its own pixel.  The ``skip`` stages' kept counts and compaction order are
held against a numpy walk of the staging batches, the transmittance rows
bitwise against the production plain rows, ``trips`` against a numpy loop
over the staging batches of each sub-tile CTA, every production-output
variant's plain version bitwise against the production plain version, and
``full`` against the JAX Pallas forward (interpret mode) at the existing
contracts: 3DGS 2e-4, surfels the JAX surfel contract
(``tests/test_torch_surfel.py``).  The breakdown entry points run with
``--device cpu`` on a tiny scene; without a card ``device=None`` raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core.camera import Camera as JCamera
from generativedensification_tpu.core.transforms import normalize_quat
from generativedensification_tpu.splat import surfel as jsur
from generativedensification_tpu.splat.binning import bin_gaussians
from generativedensification_tpu.splat.composite import composite_tiles
from generativedensification_tpu.splat.projection import (
    ProjectedGaussians,
    project_gaussians,
)
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat import probe_kernels as pk
from generativedensification_torch.splat import surfel as tsur
from generativedensification_torch.splat import surfel_kernels
from generativedensification_torch.splat.composite import _images, pack_table
from generativedensification_torch.tools import kernel_break, sass_check, scenes, surfel_break

torch.set_num_threads(1)

HW = 64
N = 2000
REL = 1e-5           # stage sums, per pixel, relative to Σ|terms|
ATOL_3DGS = 2e-4     # the JAX 3DGS backend contract
MAP_ATOL = 5e-4      # the JAX surfel contract: maps scaled by max(1, max |map|)
f32 = np.float32
T = lambda a: torch.from_numpy(np.array(a))


def _camera(znear, zfar):
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    return JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, HW, HW, znear=znear,
                            zfar=zfar)


def _bins(proj, ts, **kw):
    bins = bin_gaussians(proj, HW, HW, tile_size=ts, max_tiles=9, **kw)
    assert int(bins.overflow) == 0
    return bins, tuple(np.asarray(a) for a in (bins.sorted_ids, bins.tile_starts,
                                               bins.tile_counts))


@pytest.fixture(scope="module", params=[16, 32])
def gauss(request):
    """2,000 dense seeded Gaussians at 64² (scene A's distributions, scales
    ×8, opacity logits +3), projected and binned by JAX: the
    numpy arrays and the port's probe arguments on the same arrays."""
    ts = request.param
    rng = np.random.default_rng(0)
    means = rng.uniform(-0.45, 0.45, size=(N, 3)).astype(f32)
    shs = (rng.normal(size=(N, 4, 3)) * 0.3 + 0.2).astype(f32)
    opa = (1.0 / (1.0 + np.exp(-(rng.normal(size=N) + 2.0)))).astype(f32)
    scales = (8.0 * np.exp(rng.uniform(np.log(0.002), np.log(0.01), (N, 3)))).astype(f32)
    quats = rng.normal(size=(N, 4)).astype(f32)
    cam = _camera(0.1, 10.0)
    proj = project_gaussians(jnp.asarray(means), None, jnp.asarray(shs),
                             jnp.asarray(opa), cam, 1, jnp.asarray(scales),
                             normalize_quat(jnp.asarray(quats)))
    bins, (ids, starts, counts) = _bins(proj, ts)
    valid = np.asarray(proj.valid)
    d = dict(xy=np.asarray(proj.xy), conic=np.asarray(proj.conic),
             color=np.asarray(proj.color), depth=np.asarray(proj.depth),
             opa=np.where(valid, np.asarray(proj.opacity), 0).astype(f32),
             valid=valid, ids=ids, starts=starts, counts=counts, ts=ts,
             tx=bins.tiles_x, ty=bins.tiles_y, jbins=bins)
    table = pack_table(T(d["xy"]), T(d["conic"]), T(d["color"]), T(d["opa"]),
                       T(d["depth"]), T(valid))
    d["args"] = (table, T(ids), T(starts), T(counts), bins.tiles_x, bins.tiles_y, ts)
    return d


def _segments(d):
    """Per tile: its index, origin and segment of Gaussian ids."""
    ts, tx = d["ts"], d["tx"]
    for t in range(tx * d["ty"]):
        s, c = d["starts"][t], d["counts"][t]
        yield t, f32((t % tx) * ts), f32((t // tx) * ts), d["ids"][s:s + c]


def _gauss_eval(d, ox, oy, seg):
    """(slots, pixels) power and alpha of one tile in float32, in the
    kernel's order of operations."""
    ts = d["ts"]
    p = np.arange(ts * ts)
    px, py = (p % ts).astype(f32), (p // ts).astype(f32)
    gx = (d["xy"][seg, 0] - ox)[:, None]
    gy = (d["xy"][seg, 1] - oy)[:, None]
    a, b, c = (d["conic"][seg, i][:, None] for i in range(3))
    dx, dy = px - gx, py - gy
    q = a * dx * dx + c * dy * dy
    power = np.minimum(f32(-0.5) * q - b * dx * dy, f32(0))
    alpha = np.minimum(f32(0.99), d["opa"][seg][:, None] * np.exp(power))
    return power, alpha


def _chain(alpha, ok):
    """The transmittance chain of one tile over its slots in float32: T_final
    per pixel, the weights, and the slot before which each pixel stopped (-1
    if it never did)."""
    T_ = np.ones(alpha.shape[1], f32)
    alive = np.ones(alpha.shape[1], bool)
    stop_at = np.full(alpha.shape[1], -1)
    w = np.zeros_like(alpha)
    for j in range(alpha.shape[0]):
        use = alive & ok[j]
        U = T_ * (f32(1) - alpha[j])
        stop = use & (U < f32(1e-4))
        alive &= ~stop
        stop_at[stop] = j
        take = use & ~stop
        w[j] = np.where(take, alpha[j] * T_, 0)
        T_ = np.where(take, U, T_)
    return T_, w, stop_at


def _lanes(ts, warp_blocks):
    """(sub-tiles, 256): the tile pixel of thread t of each sub-tile's CTA
    (3DGS row-major; 2DGS each warp an 8 x 4 block)."""
    t = np.arange(pk.THREADS)
    if warp_blocks:
        x = (t // 32 % 2) * 8 + t % 8
        y = (t // 64) * 4 + t % 32 // 8
    else:
        x, y = t % 16, t // 16
    side = ts // 16
    return np.stack([(q // side * 16 + y) * ts + q % side * 16 + x
                     for q in range(side * side)])


def _subtile_of(ts):
    p = np.arange(ts * ts)
    return (p // ts // 16) * (ts // 16) + p % ts // 16


def _check_checksums(out, t, staged, kept_slots, lanes, name):
    """The load / skip rows of tile t: thread i of sub-tile q sums the staged
    values (slots, width) of the i-th slot of each batch that
    ``kept_slots[q]`` (slots, bool) keeps; row 1 (skip) the kept count."""
    for q, keep in enumerate(kept_slots):
        ref, terms = np.zeros(pk.THREADS), np.zeros(pk.THREADS)
        for base in range(0, len(staged), pk.BATCH):
            idx = base + np.flatnonzero(keep[base:base + pk.BATCH])
            ref[:len(idx)] += staged[idx].sum(1)
            terms[:len(idx)] += np.abs(staged[idx]).sum(1)
        _within(out[t, 0, lanes[q]], ref, terms, f"{name} q{q}")
        if name == "skip":
            assert (out[t, 1, lanes[q]] == keep.sum()).all(), (t, q)


def _executed(stop_at, sub_of, q, count):
    """Staging batches sub-tile q's CTA runs: batch b while any of its pixels
    is alive at its start."""
    s = stop_at[sub_of == q]
    assigned = -(-count // pk.BATCH)
    return min(s.max() // pk.BATCH + 1, assigned) if (s >= 0).all() else assigned


def _within(port, ref, terms, name):
    port = np.asarray(port, np.float64)
    assert np.all(np.abs(port - ref) <= REL * terms), (
        f"{name}: max excess {float(np.max(np.abs(port - ref) - REL * terms))}")


def test_composite_stages_match_numpy(gauss):
    """load, skip, power, alpha and trans against numpy over the slots the
    skip keeps; skip's kept counts and compaction order against a walk of
    the staging batches; trans bitwise the production plain row 4; trips
    against the batch loop of each sub-tile CTA."""
    d = gauss
    ts = d["ts"]
    out = {v: pk.composite_fwd_probe(v, *d["args"]).numpy()
           for v in ("load", "skip", "power", "alpha", "trans", "trips")}
    prod = kernels.composite_fwd_plain(*d["args"]).numpy()
    touch = kernels.subtile_touch(*d["args"]).numpy()
    lanes, sub_of = _lanes(ts, False), _subtile_of(ts)
    early = dropped = 0
    for t, ox, oy, seg in _segments(d):
        s = d["starts"][t]
        kept_slots = touch[:, s:s + len(seg)]                  # (sub-tiles, slots)
        # load: every slot at its own lane; skip: the kept ones, compacted
        staged = np.stack([d["xy"][seg, 0] - ox, d["xy"][seg, 1] - oy,
                           *d["conic"][seg].T, d["opa"][seg], *d["color"][seg].T,
                           d["depth"][seg]], axis=1).astype(np.float64)
        _check_checksums(out["load"], t, staged, np.ones_like(kept_slots), lanes,
                         "load")
        _check_checksums(out["skip"], t, staged, kept_slots, lanes, "skip")
        dropped += (~kept_slots).sum()
        kept = kept_slots[sub_of].T                            # (slots, pixels)
        power, alpha = _gauss_eval(d, ox, oy, seg)
        p64 = np.where(kept, power, 0).astype(np.float64)
        _within(out["power"][t, 0], p64.sum(0), np.abs(p64).sum(0), "power")
        hit = (alpha >= f32(1.0 / 255.0)) & kept
        a64 = np.where(hit, alpha, 0).astype(np.float64)
        _within(out["alpha"][t, 0], a64.sum(0), a64.sum(0), "alpha")
        T_, _, stop_at = _chain(alpha, hit)
        _within(out["trans"][t, 4], 1.0 - T_.astype(np.float64), np.ones_like(T_),
                "trans")
        for q in range(len(kept_slots)):
            executed = _executed(stop_at, sub_of, q, len(seg))
            trips = out["trips"][t][:3][:, lanes[q]]
            assert (trips == [[executed], [-(-len(seg) // pk.BATCH)],
                              [kept_slots[q, :executed * pk.BATCH].sum()]]).all()
            early += executed < -(-len(seg) // pk.BATCH)
    for v in ("load", "skip", "power", "alpha"):
        assert not out[v][:, 2:].any(), v
    assert not out["trans"][:, :4].any() and np.array_equal(out["trans"][:, 4], prod[:, 4])
    assert np.array_equal(out["trips"][:, 4], prod[:, 4])
    # the batch loop and the skip are exercised: several batches; at 32 px
    # slots dropped (at 16 px the sub-tile is the tile, which the binning
    # culls by the same bound), at 16 px CTAs that saturate early
    assert out["trips"][:, 1].max() > 1
    assert dropped > 0 if ts == 32 else early > 0


def test_composite_full_matches_jax_pallas(gauss):
    """``full`` (the production output) against the JAX Pallas forward of the
    same arrays, image / alpha / depth within 2e-4; every production-output
    variant's plain version is the production plain version."""
    d = gauss
    bins = d["jbins"]
    bg = np.asarray([0.3, 0.6, 0.9], f32)
    jb = (bins.sorted_ids, bins.sorted_o, bins.sorted_valid, bins.sorted_rank,
          bins.depth_order, bins.tile_starts, bins.tile_counts)
    jo = composite_tiles(jnp.asarray(d["xy"]), jnp.zeros_like(jnp.asarray(d["xy"])),
                         jnp.asarray(d["conic"]), jnp.asarray(d["color"]),
                         jnp.asarray(d["opa"]), jnp.asarray(d["depth"]), jnp.asarray(bg),
                         jb, d["tx"], d["ty"], d["ts"], 4096, 32, "pallas")
    out = pk.composite_fwd_probe("full", *d["args"])
    to = _images(out, T(bg), d["tx"], d["ty"], d["ts"])
    assert float(to[1].max()) > 0.99
    for a, b, name in zip(jo, to, ("image", "alpha", "depth")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL_3DGS, rtol=0,
                                   err_msg=name)
    for v in pk.PRODUCTION_OUTPUT:
        assert torch.equal(pk.composite_fwd_probe(v, *d["args"]), out), v


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("renderer, variant", [
    *(("3dgs", v) for v in pk.PRODUCTION_OUTPUT),
    *(("2dgs", v) for v in (*pk.SURFEL_PRODUCTION_OUTPUT, *pk.SURFEL_STAGE_ROWS)),
])
def test_production_output_variants_are_production(renderer, variant, ts):
    """Every variant whose output is the production output: its plain
    version bitwise ``composite_fwd_plain`` / ``surfel_fwd_plain`` (surfel
    trans / acc: on the rows they reach) on a tiny scene A / A′."""
    if renderer == "3dgs":
        args, _, _ = scenes.bench_scene("cpu", ts, 4, n=600, hw=64)
        ref = kernels.composite_fwd_plain(*args)
        out = pk.composite_fwd_probe_plain(variant, *args)
    else:
        args, _ = scenes.surfel_bench_scene("cpu", "free", ts, 4, n=600, hw=64)
        ref = surfel_kernels.surfel_fwd_plain(*args)
        out = pk.surfel_fwd_probe_plain(variant, *args)
    rows = list(pk.SURFEL_STAGE_ROWS.get(variant, range(ref.shape[1])))
    assert float(ref[:, rows].abs().max()) > 0
    assert torch.equal(out[:, rows], ref[:, rows])


@pytest.fixture(scope="module", params=[16, 32])
def surfels(request):
    """2,000 seeded surfels at 64² (2-D scales in [0.004, 0.02], scene A′'s
    ``free`` range, ×2), set up and binned by JAX as its
    ``rasterize_surfels`` does: the numpy arrays and the port's probe
    arguments on the same arrays."""
    ts = request.param
    rng = np.random.default_rng(1)
    means = rng.uniform(-0.45, 0.45, size=(N, 3)).astype(f32)
    shs = (rng.normal(size=(N, 4, 3)) * 0.3 + 0.2).astype(f32)
    opa = (1.0 / (1.0 + np.exp(-(rng.normal(size=N) + 1.0)))).astype(f32)
    scales = (2.0 * np.exp(rng.uniform(np.log(0.004), np.log(0.02), (N, 2)))).astype(f32)
    quats = rng.normal(size=(N, 4)).astype(f32)
    cam = _camera(0.2, 4.0)
    M, n_view, xy, depth, color, radius, valid = jsur._surfel_setup(
        *(jnp.asarray(a) for a in (means, scales, quats, opa, shs)), cam, 1)
    acr, bcr, ccr, det = jsur._surfel_coeffs(M)
    tau = jnp.log(jnp.maximum(jnp.asarray(opa), 1e-12) * 255.0)
    lam = 2.0 * jnp.maximum(tau, 1e-6) / jnp.maximum(radius, 1.0) ** 2
    proj = ProjectedGaussians(xy=xy, depth=depth,
                              conic=jnp.stack([lam, 0 * lam, lam], -1), color=color,
                              opacity=jnp.asarray(opa), radius=radius, valid=valid)
    bins, (ids, starts, counts) = _bins(proj, ts, enum_tiles=9)
    arrays = [np.asarray(a) for a in (acr, bcr, ccr, det, xy, radius, color)]
    arrays += [np.where(np.asarray(valid), opa, 0).astype(f32), np.asarray(n_view)]
    d = dict(zip(("acr", "bcr", "ccr", "det", "xy", "rad", "color", "opa", "normal"),
                 arrays))
    d.update(ids=ids, starts=starts, counts=counts, ts=ts, tx=bins.tiles_x,
             ty=bins.tiles_y, jbins=bins, planes=np.asarray([0.2, 4.0], f32))
    table = tsur.pack_surfel_table(*map(T, arrays))
    d["args"] = (table, T(ids), T(starts), T(counts), T(d["planes"]), bins.tiles_x,
                 bins.tiles_y, ts)
    return d


def _surfel_eval(d, t, seg):
    """(slots, pixels) quantities of one tile in float32, in the kernel's
    order: the circle test, alpha, the ray-plane depth z."""
    ts, tx = d["ts"], d["tx"]
    p = np.arange(ts * ts)
    X = ((t % tx) * ts + p % ts).astype(f32)
    Y = ((t // tx) * ts + p // ts).astype(f32)
    col = lambda name, i=None: (d[name][seg] if i is None else d[name][seg, i])[:, None]
    dx, dy = X - col("xy", 0), Y - col("xy", 1)
    d2 = dx * dx + dy * dy
    inside = d2 <= col("rad") * col("rad")
    cr = [(col("acr", i) + X * col("bcr", i)) + Y * col("ccr", i) for i in range(3)]
    safe = np.where(np.abs(cr[2]) < f32(1e-8), f32(1e-8), cr[2])
    rz = f32(1) / safe
    u, v = cr[0] * rz, cr[1] * rz
    g3d = f32(-0.5) * (u * u + v * v)
    g2d = f32(-0.25) * d2
    power = np.where(g3d >= g2d, g3d, g2d)
    z = col("det") * rz
    alpha = np.minimum(f32(0.99), col("opa") * np.exp(power))
    return inside, alpha, z


def test_surfel_stages_match_numpy(surfels):
    """load, skip, alpha, geomd, trans and acc against numpy over the slots
    the skip keeps; skip's kept counts and compaction order against a walk
    of the staging batches; trans and acc bitwise the production plain rows
    they reach."""
    d = surfels
    ts = d["ts"]
    out = {v: pk.surfel_fwd_probe(v, *d["args"]).numpy()
           for v in ("load", "skip", "alpha", "geomd", "trans", "acc")}
    prod = surfel_kernels.surfel_fwd_plain(*d["args"]).numpy()
    a = d["args"]
    touch = surfel_kernels.subtile_touch(*a[:4], *a[5:]).numpy()
    lanes, sub_of = _lanes(ts, True), _subtile_of(ts)
    znear, zfar = d["planes"]
    F = zfar / (zfar - znear)
    dropped = 0
    for t in range(d["tx"] * d["ty"]):
        s, c = d["starts"][t], d["counts"][t]
        seg = d["ids"][s:s + c]
        kept_slots = touch[:, s:s + c]
        staged = np.concatenate([d["acr"][seg], d["bcr"][seg], d["ccr"][seg],
                                 d["det"][seg, None], d["xy"][seg], d["opa"][seg, None],
                                 d["color"][seg], d["normal"][seg],
                                 (d["rad"][seg] * d["rad"][seg])[:, None]],
                                axis=1).astype(np.float64)
        _check_checksums(out["load"], t, staged, np.ones_like(kept_slots), lanes,
                         "load")
        _check_checksums(out["skip"], t, staged, kept_slots, lanes, "skip")
        dropped += (~kept_slots).sum()
        inside, alpha, z = _surfel_eval(d, t, seg)
        inside &= kept_slots[sub_of].T
        hit = inside & (alpha >= f32(1.0 / 255.0))
        a64 = np.where(hit, alpha, 0).astype(np.float64)
        _within(out["alpha"][t, 0], a64.sum(0), a64.sum(0), "surfel alpha")
        ok = hit & (z > f32(0.2))
        a64 = np.where(ok, alpha, 0).astype(np.float64)
        m = F * (f32(1) - znear / np.maximum(z, f32(1e-6)))
        m64 = np.where(ok, m, 0).astype(np.float64)
        _within(out["geomd"][t, 0], a64.sum(0), a64.sum(0), "geomd alpha")
        _within(out["geomd"][t, 1], m64.sum(0), np.abs(m64).sum(0), "geomd m")
        T_, w, _ = _chain(alpha, ok)
        _within(out["trans"][t, 12], T_, np.ones_like(T_), "surfel trans")
        _within(out["acc"][t, 12], T_, np.ones_like(T_), "acc T")
        attrs = np.concatenate([d["color"][seg], d["normal"][seg]], axis=1)
        wr = w.astype(np.float64)[:, None, :] * attrs[:, :, None]    # (slots, 6, px)
        _within(out["acc"][t, :6], wr.sum(0), np.abs(wr).sum(0), "acc rows")
        w64 = w.astype(np.float64)
        _within(out["acc"][t, 9], w64.sum(0), w64.sum(0), "acc wsum")
    for v in ("load", "skip", "alpha", "geomd"):
        assert not out[v][:, 2:12].any() and (out[v][:, 12] == 1).all(), v
    for v, rows in pk.SURFEL_STAGE_ROWS.items():
        rows = list(rows)
        assert np.array_equal(out[v][:, rows], prod[:, rows]), v
        rest = [r for r in range(13) if r not in rows]
        assert not out[v][:, rest].any(), v
    assert prod[:, 12].min() < 1e-3                     # some pixels saturate
    assert dropped > 0 or ts == 16       # at 16 px the sub-tile is the tile


def test_surfel_full_matches_jax_pallas(surfels):
    """``full`` against the JAX Pallas surfel forward of the same arrays at
    the JAX surfel contract."""
    d = surfels
    bins = d["jbins"]
    bg = np.asarray([0.2, 0.5, 0.8], f32)
    jb = (bins.sorted_ids, bins.sorted_o, bins.sorted_valid, bins.sorted_rank,
          bins.depth_order, bins.tile_starts, bins.tile_counts)
    names = ("acr", "bcr", "ccr", "det", "xy", "rad", "color", "opa", "normal")
    jo = jsur.composite_surfels(*(jnp.asarray(d[k]) for k in names), jnp.asarray(bg),
                                jnp.float32(0.2), jnp.float32(4.0), jb, d["tx"],
                                d["ty"], d["ts"], 4096, 32, "pallas")
    out = pk.surfel_fwd_probe("full", *d["args"])
    assert torch.equal(out, surfel_kernels.surfel_fwd_plain(*d["args"]))
    to = tsur._maps(out, T(bg), d["tx"], d["ty"], d["ts"])
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


@pytest.mark.parametrize("ts", [16, 32])
def test_wrappers_route_cpu_tensors_to_plain(ts):
    """On CPU tensors every variant name takes its plain version and launches
    nothing; an unknown name raises (tiny scenes A and A′ of the tools)."""
    args, _, _ = scenes.bench_scene("cpu", ts, 4, n=300, hw=64)
    sargs, _ = scenes.surfel_bench_scene("cpu", "free", ts, 4, n=300, hw=64)
    before = dict(kernels.launch_counts)
    for v in pk.COMPOSITE_VARIANTS:
        assert torch.equal(pk.composite_fwd_probe(v, *args),
                           pk.composite_fwd_probe_plain(v, *args)), v
    for v in pk.SURFEL_VARIANTS:
        assert torch.equal(pk.surfel_fwd_probe(v, *sargs),
                           pk.surfel_fwd_probe_plain(v, *sargs)), v
    assert kernels.launch_counts == before
    for bad in ("pvpu", "fullvpu", "full_high", "geomd"):
        with pytest.raises(ValueError, match="unknown probe variant"):
            pk.composite_fwd_probe(bad, *args)
    with pytest.raises(ValueError, match="unknown probe variant"):
        pk.surfel_fwd_probe("power", *sargs)


TINY = ["--device", "cpu", "--n", "300", "--hw", "64", "--reps", "1"]


@pytest.mark.parametrize("tool, stages", [
    (kernel_break, ["noop", "load", "skip", "power", "alpha", "trans", "full",
                    "trips", "tpb2_bulk"]),
    (surfel_break, [*surfel_break.LADDER, "noskip"]),
])
def test_breakdown_tools_on_cpu(tool, stages, capsys):
    """The breakdown entry points on a tiny scene A / A′ with ``--device
    cpu``: one line per stage, in the given order, then ``full`` beside the
    production kernel, and a JSON record whose work counts grow along the
    ladder."""
    res = tool.run([*stages, *TINY, "--tile-size", "32"])
    lines = capsys.readouterr().out.splitlines()
    timed = [ln.split()[0] for ln in lines if ln.split() and ln.split()[0] in stages
             and " ms (+" in ln]
    assert timed == stages
    assert any(ln.startswith("full") and "production" in ln for ln in lines)
    assert set(res["full_vs_production"]) == {"full", "production"}
    recs = {r["variant"]: r for r in res["stages"]}
    assert list(recs) == stages
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] >= 0 for r in recs.values())
    assert recs["noop"]["ops"] == 0 < recs["load"]["ops"] < recs["full"]["ops"]
    assert 0 < recs["skip"]["kept"] < recs["load"]["kept"]
    assert recs["skip"]["predicate_ops"] > 0 == recs["load"]["predicate_ops"]


def test_bwd_breakdown_on_cpu(capsys):
    """``kernel_break --bwd`` on the tiny scene: the backward path's stages and
    the cumulative prefixes pre_a-pre_d."""
    res = kernel_break.run(["--bwd", *TINY])
    out = capsys.readouterr().out
    names = [r["stage"] for r in res["bwd"]]
    assert names[0] == "bwd_common" and names[-4:] == ["pre_a", "pre_b", "pre_c", "pre_d"]
    assert {f"kernel {m}" for m in kernels.BWD_ROWS} <= set(names)
    assert all(n in out for n in names)


@pytest.mark.parametrize("tool", [kernel_break, surfel_break])
def test_breakdown_tools_need_a_card_by_default(tool):
    """``device=None`` means the card: without one the tools raise."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.run(["noop"])


def test_sass_check_pairs_kernels_across_defaulted_template_parameters():
    """``tools/sass_check.py`` pairs a parent kernel with the change's of the
    same symbol or, where the template gained defaulted parameters, with the
    one kernel whose template arguments extend the parent's; another tile
    size, mode or parameter list is no counterpart."""
    head, params = "_ZN7subtile20composite_fwd_kernel", "EvPKfPKiS4_S4_Pfi"
    sym = lambda args: f"{head}I{args}E{params}"
    parent = sym("Li32ELb1ELb1E")
    extended = sym("Li32ELb1ELb1ELi7ELi256ELi1ELb0E")
    assert sass_check.counterpart(parent, {parent: 1, extended: 1}) == parent
    assert sass_check.counterpart(parent, {extended: 1,
                                           sym("Li16ELb1ELb1ELi7ELi256ELi1ELb0E"): 1,
                                           sym("Li32ELb0ELb1ELi7ELi256ELi1ELb0E"): 1}
                                  ) == extended
    assert sass_check.counterpart(parent, {sym("Li32ELb1ELb0ELi7E"): 1}) is None
    assert sass_check.counterpart(parent, {f"{head}ILi32ELb1ELb1ELi7EEEvPKf": 1}) is None
    assert sass_check.counterpart(parent, {extended: 1, sym("Li32ELb1ELb1ELi6E"): 1}) is None
    assert sass_check._spills("0 bytes spill stores, 0 bytes spill loads") is False
    assert sass_check._spills("12 bytes spill stores, 20 bytes spill loads") is True

"""PyTorch port vs the JAX package: the autograd backward of the renderers
and the per-slot gradient reductions.

``composite_tiles`` / ``composite_tiles_sel`` and ``rasterize`` with its
``screen_offset`` / ``screen_abs`` hooks differentiated by
``torch.autograd.grad`` against ``jax.grad`` through JAX's XLA backend at the
3DGS gradient contract (5e-5 after scaling each array by its max |value|,
``tests/test_pallas.py:84-87``); ``rasterize_surfels`` against JAX's XLA
surfel backward at the surfel contract (2e-3 scaled,
``tests/test_pallas_surfel.py:94-98``); ``neighbor_conv27``'s autograd
gradient against JAX's custom VJP with multiply occupied voxels; and the five
``GD_APOS_MODE`` strategies of ``slots_to_gaussians`` against the default one
and against JAX's Pallas backend (interpret mode, as ``tests/test_pallas.py``
runs it) under the same mode, at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core.camera import Camera as JCamera
from generativedensification_tpu.points import modules as jmod
from generativedensification_tpu.points import structure as jst
from generativedensification_tpu.splat import composite as jcomp
from generativedensification_tpu.splat import surfel as jsur
from generativedensification_tpu.splat.rasterizer import rasterize as j_rasterize
from generativedensification_torch.core.camera import Camera as TCamera
from generativedensification_torch.points import modules as tmod
from generativedensification_torch.points import structure as tst
from generativedensification_torch.splat import composite as tcomp
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat import surfel as tsur
from generativedensification_torch.splat.rasterizer import rasterize
from test_torch_splat import N, P, TILES, _bench_like_scene, _pallas_scene
from test_torch_surfel import _scene as _surfel_scene

torch.set_num_threads(1)

GRAD_ATOL = 5e-5          # 3DGS gradients, scaled by their max |value|
SURFEL_GRAD_ATOL = 2e-3   # surfel gradients, scaled (the JAX surfel contract)
T = lambda a: torch.from_numpy(np.array(a))


def _scaled_close(a, b, atol, name):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = float(np.abs(a).max())
    assert scale > 0, f"{name}: zero reference gradient"
    np.testing.assert_allclose(b / scale, a / scale, atol=atol, rtol=0, err_msg=name)


def _bins(d):
    """The scene's segments for both packages (identity depth order)."""
    jb = (jnp.asarray(d["ids"]), jnp.asarray(d["sorted_o"]), jnp.asarray(d["valid"]),
          jnp.asarray(d["ids"]), jnp.arange(N, dtype=jnp.int32),
          jnp.asarray(d["starts"]), jnp.asarray(d["counts"]))
    tb = (T(d["ids"]), T(d["sorted_o"]), torch.arange(N, dtype=torch.int32),
          T(d["starts"]), T(d["counts"]), P)
    return jb, tb


# --------------------------------------------------------------------------
# the 3DGS compositing backward through autograd
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [16, 32])
def test_composite_tiles_autograd_matches_jax(ts):
    """Gradients of a seeded linear loss on image, alpha and depth w.r.t.
    every attribute and the background, with and without ``xy_abs``
    (backward modes ``full`` / ``noabs``), and through the fused
    ``composite_tiles_sel`` (``noabs``; no gradient to ``gt``)."""
    d = _pallas_scene(seed=3, ts=ts)
    jb, tb = _bins(d)
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2 * ts, 2 * ts, 3)).astype(np.float32)
    wa = rng.normal(size=(2 * ts, 2 * ts)).astype(np.float32)
    wd = rng.normal(size=(2 * ts, 2 * ts)).astype(np.float32)
    gt = rng.uniform(size=(2 * ts, 2 * ts, 3)).astype(np.float32)
    keys = ("xy", "conic", "color", "opa", "depth", "bg")
    names = ["xy", "xy_abs", "conic", "color", "opacity", "depth", "bg"]
    jw, tw = tuple(map(jnp.asarray, (w, wa, wd))), tuple(map(T, (w, wa, wd)))
    lin = lambda i, a, z, W: (W[0] * i).sum() + (W[1] * a).sum() + 0.1 * (W[2] * z).sum()

    for want_abs in (True, False):
        def jloss(xy, xy_abs, conic, color, opa, depth, bg):
            out = jcomp.composite_tiles(xy, xy_abs, conic, color, opa, depth, bg, jb,
                                        TILES, TILES, ts, 128, 32, "xla", 0, want_abs)
            return lin(*out, jw)

        jargs = [jnp.asarray(d["xy"]), jnp.zeros((N, 2), jnp.float32)] + \
            [jnp.asarray(d[k]) for k in keys[1:]]
        jg = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(*jargs)
        targs = [T(d["xy"]), torch.zeros((N, 2))] + [T(d[k]) for k in keys[1:]]
        for t in targs:
            t.requires_grad_(True)
        out = tcomp.composite_tiles(targs[0], *targs[2:], tb, (TILES, TILES, ts),
                                    xy_abs=targs[1] if want_abs else None)
        tg = torch.autograd.grad(lin(*out, tw), targs, allow_unused=True)
        for a, b, name in zip(jg, tg, names):
            if name == "xy_abs" and not want_abs:
                assert b is None
                continue
            _scaled_close(a, b, GRAD_ATOL, f"want_abs={want_abs} d_{name}")

    def jsel(xy, conic, color, opa, depth, bg):
        out = jcomp.composite_tiles_sel(xy, conic, color, opa, depth, bg,
                                        jnp.asarray(gt), jb, TILES, TILES, ts, 128,
                                        32, "xla")
        return lin(*out[:3], jw)

    jg = jax.jit(jax.grad(jsel, argnums=tuple(range(6))))(
        *[jnp.asarray(d[k]) for k in keys])
    targs = [T(d[k]).requires_grad_(True) for k in keys]
    gt_t = T(gt).requires_grad_(True)
    *out, sel_abs = tcomp.composite_tiles_sel(*targs, gt_t, tb, (TILES, TILES, ts))
    assert not sel_abs.requires_grad
    tg = torch.autograd.grad(lin(*out, tw), targs + [gt_t], allow_unused=True)
    assert tg[-1] is None                          # gt takes no gradient
    for a, b, name in zip(jg, tg, ["xy", "conic", "color", "opacity", "depth", "bg"]):
        _scaled_close(a, b, GRAD_ATOL, f"sel d_{name}")


def test_rasterize_screen_hooks_match_jax():
    """``rasterize(screen_offset=, screen_abs=)``: the signed and absolute
    screen-space gradients of the image MSE against a target, and the
    attribute gradients, against JAX's XLA backend; |abs| >= |signed|."""
    H = W = 64
    means, shs, opa, scales, quats = _bench_like_scene(3000, seed=2)
    scales = scales * 4.0
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    gt = np.random.default_rng(6).uniform(size=(H, W, 3)).astype(np.float32)
    kw = dict(tile_size=16, max_tiles=9, max_per_tile=512)
    jc = JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, W, H, znear=0.1, zfar=10.0)
    tc = TCamera.from_c2w(T(c2w), 0.8, 0.8, W, H, znear=0.1, zfar=10.0)
    arrays = (means, shs, opa, scales, quats)

    def jloss(m, s, o, sc, q, off, sabs):
        out = j_rasterize(m, s, o, sc, q, jc, jnp.ones(3), 1, backend="xla", chunk=32,
                          screen_offset=off, screen_abs=sabs, **kw)
        return jnp.mean((out.image - jnp.asarray(gt)) ** 2) + 0.01 * jnp.mean(out.depth)

    z = jnp.zeros((3000, 2), jnp.float32)
    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *map(jnp.asarray, arrays), z, z)
    targs = [T(a).requires_grad_(True) for a in arrays]
    off = torch.zeros((3000, 2), requires_grad=True)
    sabs = torch.zeros((3000, 2), requires_grad=True)
    out = rasterize(*targs, tc, torch.ones(3), 1, screen_offset=off, screen_abs=sabs,
                    **kw)
    loss = ((out.image - T(gt)) ** 2).mean() + 0.01 * out.depth.mean()
    tg = torch.autograd.grad(loss, targs + [off, sabs])
    names = ["means", "shs", "opacity", "scales", "quats", "screen_offset",
             "screen_abs"]
    for a, b, name in zip(jg, tg, names):
        _scaled_close(a, b, GRAD_ATOL, f"d_{name}")
    assert (tg[6] >= tg[5].abs() - 1e-7).all()
    assert float(tg[6].abs().max()) > 0


def test_rasterize_surfels_autograd_matches_jax():
    """``rasterize_surfels`` differentiated end to end (surfel setup,
    coefficients, the ``full`` backward, the six maps and the depth-derived
    normal) against JAX on its XLA backend, 2e-3 scaled."""
    arrays, jc, tc, bg = _surfel_scene(seed=4)
    rng = np.random.default_rng(2)
    wi = rng.normal(size=(64, 64, 3)).astype(np.float32)
    wn = rng.normal(size=(64, 64, 3)).astype(np.float32)
    kw = dict(tile_size=16, max_tiles=16, max_per_tile=256, enum_tiles=16)

    def lin(out, wi, wn):
        return ((out.image * wi).sum() + 0.3 * out.alpha.sum()
                + 0.2 * (out.normal * wn).sum() + 0.1 * out.depth_expected.sum()
                + 5.0 * out.dist.sum())

    def jloss(*a):
        return lin(jsur.rasterize_surfels(*a, jc, jnp.asarray(bg), sh_degree=1,
                                          backend="xla", chunk=32, **kw),
                   jnp.asarray(wi), jnp.asarray(wn))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*map(jnp.asarray, arrays))
    targs = [T(a).requires_grad_(True) for a in arrays]
    kernels.reset_launch_counts()
    out = tsur.rasterize_surfels(*targs, tc, T(bg), 1, **kw)
    tg = torch.autograd.grad(lin(out, T(wi), T(wn)), targs)
    assert not any(kernels.launch_counts.values())      # CPU: no launch
    for a, b, name in zip(jg, tg, ["means", "shs", "opacity", "scales", "quats"]):
        _scaled_close(a, b, SURFEL_GRAD_ATOL, f"d_{name}")


# --------------------------------------------------------------------------
# the submanifold conv's gradient
# --------------------------------------------------------------------------


def test_neighbor_conv27_gradient_matches_jax_custom_vjp():
    """The port's gather form differentiated by autograd against JAX's
    tap-reversed custom backward, on a coarse grid where many voxels hold
    several points (both run JAX's neighbor table): feature and kernel
    gradients at 1e-5, co-voxel duplicates get none."""
    rng = np.random.default_rng(5)
    B, Np, C, D = 2, 160, 16, 12
    coord = rng.uniform(-0.45, 0.45, (B, Np, 3)).astype(np.float32)
    feat = rng.normal(size=(B, Np, C)).astype(np.float32)
    mask = rng.uniform(size=(B, Np)) > 0.15
    w = (rng.normal(size=(27, C, D)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(B, Np, D)).astype(np.float32)
    jps = jst.PointSet(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                       mask=jnp.asarray(mask), grid_size=1 / 6)
    nbr = jst.compute_neighbor_idx(jst.serialize_pointset(jps)).neighbor_idx
    rep = np.asarray(nbr[..., 13])
    dup = mask & (rep != np.arange(Np)[None])
    assert dup.sum() > 0                                 # co-voxel duplicates

    def jf(f, ww):
        return jnp.sum(jmod.neighbor_conv27(f, nbr, ww, jnp.float32) * ct)

    jgf, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(w))
    tf, tw = T(feat).requires_grad_(True), T(w).requires_grad_(True)
    y = tmod.neighbor_conv27(tf, T(np.asarray(nbr)).long(), tw)
    gf, gw = torch.autograd.grad((y * T(ct)).sum(), (tf, tw))
    np.testing.assert_allclose(gf.numpy(), np.asarray(jgf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-5, rtol=1e-5)
    assert float(gf[torch.from_numpy(dup)].abs().max()) == 0.0
    # the port's own table differs from JAX's only in co-voxel picks
    tps = tst.compute_neighbor_idx(tst.serialize_pointset(
        tst.PointSet(coord=T(coord), feat=tf, mask=T(mask), grid_size=1 / 6)))
    assert (tps.neighbor_idx.numpy() >= 0).sum() == (np.asarray(nbr) >= 0).sum()


# --------------------------------------------------------------------------
# the per-slot reduction strategies (GD_APOS_MODE)
# --------------------------------------------------------------------------


def _slot_scene(seed):
    """``tests/test_pallas.py``'s scene with a depth order that is not the
    identity, so the ``rank*`` keys differ from the Gaussian ones."""
    d = _pallas_scene(seed=seed)
    order = np.random.default_rng(seed + 100).permutation(N).astype(np.int32)
    rank = np.empty(N, np.int32)
    rank[order] = np.arange(N, dtype=np.int32)
    return d, order, rank


@pytest.mark.parametrize("mode", ["gauss", "rank", "gauss_dsum", "rank_dsum",
                                  "gauss_dsum_col"])
def test_apos_modes_match_default_and_jax(mode, monkeypatch):
    """Each strategy gives the ``gauss_dsum`` sums bit for bit (same rows,
    same order), with and without a pair budget, and so the same ``xy_abs``
    gradient through the whole backward; that gradient matches JAX's Pallas
    backend under the same ``APOS_MODE`` at the 3DGS contract (5e-5 scaled:
    the two backward kernels sum a slot's pixels in different orders, ~7e-6
    scaled here; ROADMAP queue 3), and JAX's own strategies agree with each
    other within 1e-6, as ``tests/test_pallas.py`` holds them.  ``gauss`` /
    ``rank`` go through ``kernels.reduce_slots``, ``gauss_dsum_col`` through
    ``kernels.transpose_rows`` (their plain versions here)."""
    d, order, rank = _slot_scene(seed=5)
    rows = T(np.random.default_rng(9).normal(size=(P, 12)).astype(np.float32))
    n_slots = 2 * N
    order_t = torch.from_numpy(order)
    cut = P - 30          # a pair budget: only the first sorted slots survive
    reduce = lambda r, o: tcomp.slots_to_gaussians(r, o, order_t, n_slots)
    keys = ("xy", "conic", "color", "opa", "depth", "bg")
    # JAX's slab gather composes depth_order[sorted_rank], so sorted_rank is
    # the rank of each slot's Gaussian
    jb = (jnp.asarray(d["ids"]), jnp.asarray(d["sorted_o"]), jnp.asarray(d["valid"]),
          jnp.asarray(rank[d["ids"]]), jnp.asarray(order), jnp.asarray(d["starts"]),
          jnp.asarray(d["counts"]))
    tb = (T(d["ids"]), T(d["sorted_o"]), order_t, T(d["starts"]), T(d["counts"]),
          n_slots)

    def jgrad():
        def jloss(xy_abs):
            img, alpha, dep = jcomp.composite_tiles(
                jnp.asarray(d["xy"]), xy_abs, *(jnp.asarray(d[k]) for k in keys[1:]),
                jb, TILES, TILES, 32, 128, 32, "pallas")
            return jnp.sum(img) + jnp.sum(alpha * dep)
        return np.asarray(jax.grad(jloss)(jnp.zeros((N, 2), jnp.float32)))

    def tgrad():
        xy_abs = torch.zeros((N, 2), requires_grad=True)
        img, alpha, dep = tcomp.composite_tiles(
            T(d["xy"]), *(T(d[k]) for k in keys[1:]), tb, (TILES, TILES, 32),
            xy_abs=xy_abs)
        return torch.autograd.grad(img.sum() + (alpha * dep).sum(), xy_abs)[0]

    for pkg in (tcomp, jcomp):
        monkeypatch.setattr(pkg, "APOS_MODE", "gauss_dsum")
    ref = reduce(rows, T(d["sorted_o"]))
    ref_cut = reduce(rows[:cut], T(d["sorted_o"][:cut]))
    g_ref, jg_ref = tgrad(), jgrad()
    for pkg in (tcomp, jcomp):
        monkeypatch.setattr(pkg, "APOS_MODE", mode)
    assert torch.equal(reduce(rows, T(d["sorted_o"])), ref)
    assert torch.equal(reduce(rows[:cut], T(d["sorted_o"][:cut])), ref_cut)
    kernels.reset_launch_counts()
    g, jg = tgrad(), jgrad()
    assert not any(kernels.launch_counts.values())      # CPU: no launch
    assert torch.equal(g, g_ref)
    np.testing.assert_allclose(jg, jg_ref, atol=1e-6, rtol=0, err_msg=mode)
    _scaled_close(jg, g, GRAD_ATOL, mode)


def test_apos_mode_rejects_unknown(monkeypatch):
    monkeypatch.setattr(tcomp, "APOS_MODE", "gauss_sum")
    with pytest.raises(ValueError, match="GD_APOS_MODE"):
        tcomp.slots_to_gaussians(torch.zeros((4, 2)), torch.arange(4, dtype=torch.int32),
                                 torch.arange(2, dtype=torch.int32), 4)

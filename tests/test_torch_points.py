"""PyTorch port vs the JAX package: serialization codes, the masked point
ops, the point structure (orders, neighbor table) and the densification
decoder's modules with bridged weights.

Inputs are seeded numpy arrays handed to both packages; Flax parameters are
filled with seeded numpy values and reach the port through
``utils.convert.state_dict_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.points import modules as jmod
from generativedensification_tpu.points import ops as jops
from generativedensification_tpu.points import structure as jst
from generativedensification_tpu.serialization.encode import encode as j_encode
from generativedensification_torch.points import modules as tmod
from generativedensification_torch.points import ops as tops
from generativedensification_torch.points import structure as tst
from generativedensification_torch.serialization import ORDERS
from generativedensification_torch.serialization import encode as t_encode
from test_torch_models import _apply, _close, _load, _np_params, _rand

torch.set_num_threads(1)

OPS_TOL = dict(rtol=1e-5, atol=1e-6)
MODULE_TOL = dict(rtol=0, atol=1e-4)
T = lambda a: torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# serialization: exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("depth", [3, 8, 16])
def test_codes_bit_identical(order, depth):
    """The int64 key equals JAX's (hi, lo) uint32 pair as hi·2^24 + lo."""
    gc = np.random.default_rng(depth).integers(0, 1 << depth, (2, 400, 3)).astype(np.int32)
    pair = np.asarray(j_encode(jnp.asarray(gc), depth=depth, order=order))
    pair = pair.astype(np.uint32).astype(np.int64)
    key = t_encode(T(gc), depth=depth, order=order).numpy()
    np.testing.assert_array_equal(key, pair[..., 0] * 2 ** 24 + pair[..., 1])


def _pointset_inputs(seed, B=2, N=192, C=8, grid=1 / 32, p_invalid=0.2):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    feat = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > p_invalid
    return coord, feat, mask, grid


def _both(coord, feat, mask, grid):
    jps = jst.PointSet(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                       mask=jnp.asarray(mask), grid_size=grid)
    tps = tst.PointSet(coord=T(coord), feat=T(feat), mask=T(mask), grid_size=grid)
    return jps, tps


def test_serialize_orders_and_inverses_exact():
    """Orders, inverses and grid coords equal JAX's, with invalid points
    sorted by (hi = max, lo) at each sample's tail."""
    jps, tps = _both(*_pointset_inputs(0))
    jo = jst.serialize_pointset(jps)
    to = tst.serialize_pointset(tps)
    np.testing.assert_array_equal(np.asarray(jo.grid_coord), to.grid_coord.numpy())
    np.testing.assert_array_equal(np.asarray(jo.orders), to.orders.numpy())
    np.testing.assert_array_equal(np.asarray(jo.inverses), to.inverses.numpy())
    assert tst.depth_for_grid(1 / 64) == jst.depth_for_grid(1 / 64) == 8


def test_neighbor_table_matches_up_to_co_voxel_representative():
    """Misses and singly occupied voxels exactly; where several points
    share a voxel, both tables name a point of the queried voxel (JAX picks
    its representative through an unstable sort, so the pick itself is not
    reproducible)."""
    # a coarse grid so that many voxels hold several points
    jps, tps = _both(*_pointset_inputs(1, N=384, grid=1 / 8))
    jn = np.asarray(jst.compute_neighbor_idx(jst.serialize_pointset(jps)).neighbor_idx)
    ts = tst.compute_neighbor_idx(tst.serialize_pointset(tps))
    tn = ts.neighbor_idx.numpy()
    gc = ts.grid_coord.numpy()
    mask = ts.mask.numpy()
    r = np.arange(-1, 2)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    np.testing.assert_array_equal(jn < 0, tn < 0)                  # misses
    key = lambda g: (g[..., 0] * 1024 + g[..., 1]) * 1024 + g[..., 2]
    want = key(gc[:, :, None, :] + offs)                          # queried voxel
    hit = tn >= 0
    n_shared = 0
    for b in range(gc.shape[0]):
        occupied, count = np.unique(key(gc[b][mask[b]]), return_counts=True)
        pts = key(gc[b])
        for table in (jn[b], tn[b]):                 # both land in the voxel
            np.testing.assert_array_equal(pts[table[hit[b]]], want[b][hit[b]])
        single = count[np.searchsorted(occupied, want[b][hit[b]])] == 1
        np.testing.assert_array_equal(jn[b][hit[b]][single], tn[b][hit[b]][single])
        n_shared += int((~single).sum())
    assert n_shared > 0


# --------------------------------------------------------------------------
# masked ops: rtol 1e-5 / atol 1e-6, index sets exact
# --------------------------------------------------------------------------


def test_masked_ops():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 50, 6)).astype(np.float32)
    logits = rng.normal(size=(2, 50)).astype(np.float32) * 3
    mask = rng.uniform(size=(2, 50)) > 0.3
    mask[1] = False                       # a fully masked row stays finite
    _close(jops.masked_mean(jnp.asarray(x), jnp.asarray(mask)),
           tops.masked_mean(T(x), T(mask)), **OPS_TOL)
    _close(jops.masked_layer_norm(jnp.asarray(x)), tops.masked_layer_norm(T(x)),
           **OPS_TOL)
    sm = tops.masked_softmax(T(logits), T(mask))
    assert torch.isfinite(sm).all()
    _close(jops.masked_softmax(jnp.asarray(logits), jnp.asarray(mask)), sm, **OPS_TOL)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))
    np.testing.assert_array_equal(
        np.asarray(jops.top_p_mask(jnp.asarray(prob), jnp.asarray(mask), 0.6)),
        tops.top_p_mask(T(prob), T(mask), 0.6).numpy())
    hard = rng.uniform(size=(2, 50)) > 0.5
    p = rng.uniform(size=(2, 50)).astype(np.float32)
    _close(jops.straight_through(jnp.asarray(x), jnp.asarray(p)),
           tops.straight_through(T(x), T(p)), **OPS_TOL)
    _close(jops.straight_through_res(jnp.asarray(x), jnp.asarray(p), jnp.asarray(hard)),
           tops.straight_through_res(T(x), T(p), T(hard)), **OPS_TOL)


def test_topk_split_ties_exact():
    """Ties at 0 (Gaussians no source view sees) and -1 (pool padding) break
    by the lower index, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(3)
    score = rng.uniform(size=(2, 300)).astype(np.float32)
    score[:, rng.choice(300, 120, replace=False)] = 0.0
    score[:, rng.choice(300, 60, replace=False)] = -1.0
    mask = rng.uniform(size=(2, 300)) > 0.1
    for k in (100, 200, 260):     # boundaries inside the positive, 0 and -1 runs
        jo = jops.topk_split(jnp.asarray(score), jnp.asarray(mask), k)
        to = tops.topk_split(T(score), T(mask), k)
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(
            np.asarray(jops.topk_mask(jnp.asarray(score), jnp.asarray(mask), k)),
            tops.topk_mask(T(score), T(mask), k).numpy())


# --------------------------------------------------------------------------
# modules with bridged weights: atol 1e-4
# --------------------------------------------------------------------------


def _serialized(seed, N=96, C=32, grid=1 / 16):
    jps, tps = _both(*_pointset_inputs(seed, B=2, N=N, C=C, grid=grid))
    jps = jst.compute_neighbor_idx(jst.serialize_pointset(jps))
    tps = tst.compute_neighbor_idx(tst.serialize_pointset(tps))
    # the co-voxel representative is JAX's pick (see the table test above)
    return jps, tps.replace(neighbor_idx=T(np.asarray(jps.neighbor_idx)).long())


def test_window_attention():
    jps, tps = _serialized(4)
    jm = jmod.WindowAttention(32, 4, 48, order_index=2)
    p = _np_params(jm, jps)
    _close(_apply(jm, p, jps), _load(tmod.WindowAttention(32, 4, 48, order_index=2),
                                     p)(tps), **MODULE_TOL)


def test_neighbor_conv27():
    jps, tps = _serialized(5)
    w = _rand(27, 32, 24, seed=6, scale=0.05)
    ref = jmod.neighbor_conv27(jps.feat, jps.neighbor_idx, jnp.asarray(w), jnp.float32)
    _close(ref, tmod.neighbor_conv27(tps.feat, tps.neighbor_idx, T(w)), **MODULE_TOL)


@pytest.mark.parametrize("pdnorm_n", [0, 3])
def test_block(pdnorm_n):
    jps, tps = _serialized(7)
    kw = dict(patch_size=48, order_index=1)
    jm = jmod.Block(channels=32, num_heads=4, pdnorm_n=pdnorm_n, **kw)
    p = _np_params(jm, jps)
    tm = _load(tmod.Block(32, 4, pdnorm_n=pdnorm_n, **kw), p)
    with torch.no_grad():
        _close(_apply(jm, p, jps).feat, tm(tps).feat, **MODULE_TOL)


@pytest.mark.parametrize("carry", [False, True])
def test_upscale_module(carry):
    jps, tps = _serialized(8)
    attr = _rand(2, 96, 20, seed=9)
    jps = jps.replace(attribute=jnp.asarray(attr))
    tps = tps.replace(attribute=T(attr))
    jm = jmod.UpscaleModule(in_channels=32, out_channels=48, upscale_factor=4,
                            carry_attribute=carry)
    p = _np_params(jm, jps)
    tm = _load(tmod.UpscaleModule(32, 48, 4, carry_attribute=carry), p)
    jo = _apply(jm, p, jps)
    with torch.no_grad():
        to = tm(tps)
    for f in ("coord", "feat", "attribute"):
        _close(getattr(jo, f), getattr(to, f), **MODULE_TOL)
    np.testing.assert_array_equal(np.asarray(jo.mask), to.mask.numpy())
    pe_j = jmod.positional_encoding(2.0 ** jnp.arange(15), jnp.asarray(attr[..., :3]))
    _close(pe_j, tmod.positional_encoding(2.0 ** torch.arange(15.0), T(attr[..., :3])),
           **OPS_TOL)


@pytest.mark.parametrize("kind", ["topk", "top_p"])
@pytest.mark.parametrize("residual", [False, True])
def test_mask_modules(kind, residual):
    jps, tps = _serialized(10)
    jcls, tcls = ((jmod.MaskResModule, tmod.MaskResModule) if residual
                  else (jmod.MaskModule, tmod.MaskModule))
    jm = jcls(32, 1.0, 0.75, kind)
    p = _np_params(jm, jps)
    tm = _load(tcls(32, 1.0, 0.75, kind), p)
    jo = _apply(jm, p, jps)
    with torch.no_grad():
        to = tm(tps)
    if residual:
        (jps2, jsplit, jnl), (tps2, tsplit, tnl) = jo, to
        _close(jps2.feat, tps2.feat, **MODULE_TOL)
        _close(jps2.prob, tps2.prob, **MODULE_TOL)
        np.testing.assert_array_equal(np.asarray(jnl), tnl.numpy())
        if kind == "topk":
            for a, b in zip(jsplit, tsplit):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
            _close(a.feat, b.feat, **MODULE_TOL)
            _close(a.coord, b.coord, **MODULE_TOL)


def test_gaussian_module_and_split():
    x = _rand(2, 40, 48, seed=11)
    jm = jmod.GaussianModule(48, 1)
    p = _np_params(jm, jnp.asarray(x))
    tm = _load(tmod.GaussianModule(48, 1), p)
    jo = _apply(jm, p, jnp.asarray(x))
    to = tm(T(x))
    _close(jo, to, **MODULE_TOL)
    for a, b in zip(jmod.split_attributes(jo, 1), tmod.split_attributes(to, 1)):
        assert a.shape == tuple(b.shape)


def test_global_pooling():
    jps, tps = _both(*_pointset_inputs(12))
    _close(jmod.GlobalPooling().apply({}, jps).global_feat,
           tmod.global_pooling(tps).global_feat, **OPS_TOL)

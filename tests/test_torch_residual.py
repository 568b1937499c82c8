"""PyTorch port vs the JAX package: residual attribute mode
(``enable_residual_attribute=True``), forward and backward.

``MaskResModule`` (the softmax gate with the hard-mask straight-through)
and one whole residual ``DensifierStage`` (serialization, a block, the
``UpscaleModule`` carrying the parent attribute, the head added to it, the
gate and the split), for ``mask_sampling_type`` ``topk`` and ``top_p``
(``top_p`` keeps both sets at full size with validity masks).  Inputs and
cotangents are seeded numpy arrays handed to both packages; parameters are
filled with seeded numpy values and reach the port through
``utils.convert.state_dict_from_flax``.  Forward within ``FWD_ATOL``, the
vector-Jacobian product (input features, parent attributes, coordinates and
every parameter) within ``GRAD_ATOL`` after scaling each array by its max
|value|.

The gate's ``net_fc2.bias`` has an analytically zero gradient: it shifts
every point's logit alike, and a softmax over the points ignores that.  It
is rounding noise in both packages, so it is held negligible
(``ZERO_GRAD_TOL`` of the largest gradient) in each instead of compared
(ROADMAP queue 3).  The stage test inherits two allowances of
``tests/test_torch_fine.py``: JAX's co-voxel neighbor representative is
substituted, and ``delta_x_fc2`` is scaled by 1e-2 (its 2^14 positional
encoding frequency amplifies f32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.models import network as jnet
from generativedensification_tpu.points import modules as jmod
from generativedensification_tpu.points import structure as jst
from generativedensification_torch.models import network as tnet
from generativedensification_torch.points import modules as tmod
from generativedensification_torch.points import structure as tst
from generativedensification_torch.utils.convert import state_dict_from_flax
from test_torch_fine import _jax_neighbor_table
from test_torch_models import _np_params, _rand
from test_torch_points import _pointset_inputs

torch.set_num_threads(1)

FWD_ATOL = 1e-5
GRAD_ATOL = 5e-5          # after scaling each array by its max |value|
ZERO_GRAD = ("mask.net_fc2.bias", "net_fc2.bias")
ZERO_GRAD_TOL = 1e-6      # of the largest gradient
T = lambda a: torch.from_numpy(np.array(a))
KINDS = ["topk", "top_p"]


def _scaled_grads_close(ref: dict, got: dict) -> float:
    """Each array of ``got`` against ``ref`` scaled by its max |value|;
    the analytically zero ones negligible in both.  Returns the worst
    scaled error."""
    assert set(ref) == set(got), set(ref) ^ set(got)
    gmax = max(float(np.abs(a).max()) for a in ref.values())
    worst = 0.0
    for k, a in ref.items():
        b = got[k]
        assert a.shape == b.shape, k
        if k in ZERO_GRAD:
            for g in (a, b):
                assert float(np.abs(g).max()) <= ZERO_GRAD_TOL * gmax, k
            continue
        scale = float(np.abs(a).max())
        assert scale > 0, k
        err = float(np.abs(b - a).max()) / scale
        worst = max(worst, err)
        assert err <= GRAD_ATOL, (k, err)
    return worst


def _port_grads(module, inputs: dict) -> dict:
    grads = {k: v.grad.numpy() for k, v in inputs.items()}
    grads.update({k: p.grad.numpy() for k, p in module.named_parameters()})
    return grads


@pytest.mark.parametrize("kind", KINDS)
def test_mask_res_module_vjp(kind):
    """The gate alone on 2 × 192 points (a fifth invalid): the gated
    features, the softmax probabilities, the non-leaf mask and the split
    indices; then the VJP of a seeded cotangent on the features and the
    probabilities with respect to the input features and the weights."""
    coord, feat, mask, grid = _pointset_inputs(21, C=32)
    g_feat = _rand(*feat.shape, seed=22)
    g_prob = _rand(*mask.shape, seed=23, scale=10.0)
    jm = jmod.MaskResModule(32, 1.0, 0.75, kind)
    jps = jst.PointSet(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                       mask=jnp.asarray(mask), grid_size=grid)
    p = jax.tree.map(np.asarray, _np_params(jm, jps, seed=24))

    def jloss(params, f):
        (ps, _, _) = jm.apply(params, jps.replace(feat=f))
        return (jnp.sum(ps.feat * g_feat) + jnp.sum(ps.prob * g_prob),
                (ps.feat, ps.prob))

    jo, split, nl = jax.jit(lambda params, f: jm.apply(params, jps.replace(feat=f)))(
        p, jnp.asarray(feat))
    (_, (jfeat, jprob)), (gp, gf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(feat))
    ref = {k: v.numpy() for k, v in state_dict_from_flax(gp["params"]).items()}
    ref["feat"] = np.asarray(gf)

    tm = tmod.MaskResModule(32, 1.0, 0.75, kind)
    tm.load_state_dict(state_dict_from_flax(p["params"]))
    tfeat = T(feat).requires_grad_()
    tps, tsplit, tnl = tm(tst.PointSet(coord=T(coord), feat=tfeat, mask=T(mask),
                                       grid_size=grid))
    (torch.sum(tps.feat * T(g_feat)) + torch.sum(tps.prob * T(g_prob))).backward()

    np.testing.assert_array_equal(np.asarray(nl), tnl.numpy())
    assert 0 < int(tnl.sum()) < int(mask.sum())
    if kind == "topk":
        for a, b in zip(split, tsplit):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        assert split is None and tsplit is None
    for a, b, name in ((jfeat, tps.feat, "feat"), (jprob, tps.prob, "prob"),
                       (jo.feat, tps.feat, "feat (forward)")):
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=FWD_ATOL,
                                   rtol=0, err_msg=name)
    worst = _scaled_grads_close(ref, _port_grads(tm, {"feat": tfeat}))
    print(f"MaskResModule {kind}: worst scaled gradient error {worst:.3e}")


# a three-level residual decoder, so that the middle stage has both the
# gate (non_leaf_ratio < 1) and the parent attribute (stage > 0)
STAGE_CFG = dict(
    dec_depths=(1, 1, 1), dec_channels=(32, 48, 64), dec_num_head=(4, 6, 8),
    dec_patch_size=(48, 48, 48), non_leaf_ratio=(0.75, 0.75), stride=(2, 2),
    upscale_factor=(2, 2, 4), drop_path=0.0, shuffle_orders=False,
    enable_residual_attribute=True,
)
N_ATTR = 3 * 4 + 8         # sh_degree 1: 12 SH, opacity, 3 scales, 4 rotation


def _stage_inputs(seed, N=96):
    """Stage 1's input: the previous level's non-leaf points on the ×2
    residual grid (coordinates in [-0.9, 0.9]), 48-channel features and
    parent attributes."""
    coord, feat, mask, _ = _pointset_inputs(seed, N=N, C=48)
    attr = _rand(2, N, N_ATTR, seed=seed + 1, scale=0.5)
    return 2 * coord, feat, mask, attr


@pytest.mark.parametrize("kind", KINDS)
def test_residual_stage_vjp(kind, monkeypatch):
    """``DensifierStage`` 1 of a three-level residual decoder: the non-leaf
    and leaf sets (coordinates, features, accumulated attributes, validity
    masks) forward, then the VJP of seeded cotangents on all of them with
    respect to the input features, the parent attributes, the input
    coordinates and every parameter of the stage."""
    jcfg = jnet.NetworkConfig(mask_sampling_type=kind, **STAGE_CFG)
    tcfg = tnet.NetworkConfig(mask_sampling_type=kind, **STAGE_CFG)
    grid = 0.5 * jcfg.voxel_size
    coord, feat, mask, attr = _stage_inputs(31)
    jstage = jnet.DensifierStage(jcfg, 1)
    jps = jst.PointSet(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                       mask=jnp.asarray(mask), grid_size=grid,
                       attribute=jnp.asarray(attr))
    p = jax.tree.map(np.asarray, _np_params(jstage, jps, seed=32))
    p["params"]["up"]["delta_x_fc2"]["kernel"] *= np.float32(1e-2)

    outs = lambda nl, lf: (nl.coord, nl.feat, nl.attribute, lf.coord, lf.attribute)
    # the sets' sizes from 2 × 96 children: topk gathers 144 non-leaf and 48
    # leaf points, top_p keeps both at 192
    n_nl, n_lf = (144, 48) if kind == "topk" else (192, 192)
    shapes = [(2, n_nl, 3), (2, n_nl, 64), (2, n_nl, N_ATTR), (2, n_lf, 3),
              (2, n_lf, N_ATTR)]
    cots = [_rand(*s, seed=40 + i) for i, s in enumerate(shapes)]

    def jrun(params, f, a, c):
        nl, lf = jstage.apply(params, jps.replace(coord=c, feat=f, attribute=a))
        o = outs(nl, lf)
        return sum(jnp.sum(x * g) for x, g in zip(o, cots)), (o, nl.mask, lf.mask)

    (_, (jo, jnl_mask, jlf_mask)), (gp, gf, ga, gc) = jax.jit(jax.value_and_grad(
        jrun, argnums=(0, 1, 2, 3), has_aux=True))(
        p, jnp.asarray(feat), jnp.asarray(attr), jnp.asarray(coord))
    ref = {k: v.numpy() for k, v in state_dict_from_flax(gp["params"]).items()}
    ref.update(feat=np.asarray(gf), attribute=np.asarray(ga), coord=np.asarray(gc))

    monkeypatch.setattr(tnet, "compute_neighbor_idx",
                        _jax_neighbor_table(tnet.compute_neighbor_idx))
    tstage = tnet.DensifierStage(tcfg, 1).eval()
    sd = state_dict_from_flax(p["params"])
    assert set(sd) == set(tstage.state_dict()), set(sd) ^ set(tstage.state_dict())
    tstage.load_state_dict(sd)
    inputs = {k: T(v).requires_grad_() for k, v in
              (("feat", feat), ("attribute", attr), ("coord", coord))}
    nl, lf = tstage(tst.PointSet(mask=T(mask), grid_size=grid, **inputs))
    to = outs(nl, lf)
    sum(torch.sum(x * T(g)) for x, g in zip(to, cots)).backward()

    assert nl.grid_size == grid / 2 and lf.grid_size == grid
    np.testing.assert_array_equal(np.asarray(jnl_mask), nl.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jlf_mask), lf.mask.numpy())
    assert 0 < int(nl.mask.sum()) < int(np.repeat(mask, 2, 1).sum())
    for a, b, name in zip(jo, to, ("non_leaf coord", "non_leaf feat",
                                   "non_leaf attribute", "leaf coord",
                                   "leaf attribute")):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=FWD_ATOL,
                                   rtol=0, err_msg=name)
    worst = _scaled_grads_close(ref, _port_grads(tstage, inputs))
    print(f"residual stage {kind}: worst scaled gradient error {worst:.3e}")

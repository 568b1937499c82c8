"""PyTorch port vs the JAX package: the bf16 compute policy
(``tpu.compute_dtype=bfloat16``, the config default).

Every JAX function here is compiled with XLA's excess precision off
(``exact_bf16_jax``).  With it on (XLA's default) the compiler drops some
of the modules' bf16 roundings: a bf16 residual sum that only a
LayerNorm's f32 statistics read stays f32, and some bf16 sums of the
densifier's offset head stay f32.  Compiled so, JAX rounds where its Flax
modules say, which is where the port rounds (``models/precision.py``).

Each helper of ``models/precision.py`` is held against its Flax layer
(``test_precision_helper_matches_flax``, ``test_logits_f32_matches_flax``):
bitwise, except where the two packages sum the same f32 products in
another order (GEMM accumulation, LayerNorm statistics); those elements
are at most ``HELPER_ULP_SHARE`` of the output, each one bf16 rounding
step apart.

The contract (ROADMAP queue 3) for each compared array (a ``ViTBlock``, the
ViT, the volume transformer, a point-decoder ``Block`` with
``neighbor_conv27``, the tiny whole-network forward with the fine stage,
and one tiny train micro-step's loss and scaled gradients, coarse only and
with the fine stage): with the same f32 weights and inputs in both
packages, and the distance ``d(a, b) = ||a - b||₂ / ||JAX f32||₂`` over
the compared arrays,

  * ``d(port bf16, JAX bf16) <= r * d(JAX bf16, JAX f32)``, with ``r``
    ``MODULE_RATIO`` for the modules and ``NETWORK_RATIO`` for the whole
    network and the train steps (whose selections, sorts and rasterizer
    turn the helpers' last-place differences into larger ones);
  * ``SELF_LOW <= d(port bf16, port f32) / d(JAX bf16, JAX f32) <=
    SELF_HIGH``: bf16 moves the port about as far as it moves JAX, so a
    port whose bf16 rounds nothing (or too much) fails.

Gradients are each scaled by their JAX f32 max |value| before they are
concatenated (the ViT attention's key bias, analytically zero, is left out,
as in ``tests/test_torch_train_step.py``).  The measured ratios are
printed (``pytest -s``) and recorded in ROADMAP queue 3.  The whole-network
and train-step comparisons inherit the allowances of
``tests/test_torch_fine.py`` (JAX's co-voxel neighbor table, the
UpscaleModule's ``delta_x_fc2`` scaled by 1e-2), and both selection boundaries
(f32 and bf16) must clear 1e-3 of the largest score."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from generativedensification_tpu.data.synthetic import make_probe_batch as j_probe
from generativedensification_tpu.models import backbone as jbb
from generativedensification_tpu.models import network as jnet
from generativedensification_tpu.models import vit as jvit
from generativedensification_tpu.points import modules as jmod
from generativedensification_torch.data.synthetic import make_probe_batch as t_probe
from generativedensification_torch.models import backbone as tbb
from generativedensification_torch.models import network as tnet
from generativedensification_torch.models import precision
from generativedensification_torch.models import vit as tvit
from generativedensification_torch.points import modules as tmod
from test_torch_fine import FINE, _boundary_margin, _jax_neighbor_table
from test_torch_fine_2dgs import _jax_params
from test_torch_models import _apply, _load, _np_params, _rand
from test_torch_points import _serialized

torch.set_num_threads(1)

MODULE_RATIO = 1e-3
NETWORK_RATIO = 0.25
SELF_LOW, SELF_HIGH = 0.5, 2.0
HELPER_ULP_SHARE = 1e-3
EXACT_BF16 = {"xla_allow_excess_precision": False}
BF16 = (jnp.bfloat16, torch.bfloat16)
F32 = (jnp.float32, torch.float32)


@pytest.fixture(autouse=True)
def exact_bf16_jax(monkeypatch):
    """Compile every ``jax.jit`` of the test with XLA's excess precision
    off (the module docstring says why)."""
    real_jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda fun, **kw: real_jit(
        fun, compiler_options=EXACT_BF16, **kw))


def _flat(xs) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in xs])


def check_contract(name, j32, j16, t32, t16, ratio):
    """The two inequalities of the module docstring over the flattened
    arrays, the first with ``ratio``; returns and prints the two ratios."""
    j32, j16, t32, t16 = map(_flat, (j32, j16, t32, t16))
    norm = np.linalg.norm(j32)
    d = lambda a, b: np.linalg.norm(a - b) / norm
    base = d(j16, j32)
    assert base > 0, f"{name}: bf16 changed nothing"
    r_jax, r_self = d(t16, j16) / base, d(t16, t32) / base
    print(f"[bf16 {name}] d(JAX bf16, JAX f32) {base:.3e}; "
          f"d(port bf16, JAX bf16) {r_jax:.3e}x; d(port bf16, port f32) {r_self:.4f}x")
    assert r_jax <= ratio, (name, r_jax)
    assert SELF_LOW <= r_self <= SELF_HIGH, (name, r_self)
    return r_jax, r_self


def test_contract_rejects_a_port_without_bf16():
    """A port whose bf16 ran in f32 (its bf16 output its f32 output) fails
    both inequalities, as does one that rounds twice as coarsely."""
    rng = np.random.default_rng(0)
    j32 = rng.normal(size=1000)
    j16 = j32 + 1e-2 * rng.normal(size=1000)
    with pytest.raises(AssertionError):
        check_contract("f32 port", j32, j16, j32, j32, NETWORK_RATIO)
    with pytest.raises(AssertionError):
        check_contract("coarse port", j32, j16, j32, j32 + 3 * (j16 - j32), 10.0)
    check_contract("faithful port", j32, j16, j32, j16, NETWORK_RATIO)


def _bf16_ulp(v: float) -> float:
    """One bf16 unit in the last place at magnitude ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _helper_case(name: str):
    """(Flax layer output, port helper output) in bf16 for one helper on
    seeded inputs, at the layer shapes the network uses."""
    rng = np.random.default_rng(3)
    x = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    bf = torch.bfloat16

    def flax(layer, inp):
        p = _np_params(layer, jnp.asarray(inp))
        return p, np.asarray(_apply(layer, p, jnp.asarray(inp)).astype(jnp.float32))

    if name == "dense":          # a ViT-B projection, 768 -> 768
        inp = x(64, 768)
        p, j = flax(fnn.Dense(768, dtype=jnp.bfloat16), inp)
        return j, precision.dense(_load(nn.Linear(768, 768), p), torch.from_numpy(inp), bf)
    if name == "conv2d":         # the ViT patch embedding, 16 x 16 stride 16
        inp = x(2, 64, 64, 3)
        p, j = flax(fnn.Conv(96, (16, 16), strides=(16, 16), padding="VALID",
                             dtype=jnp.bfloat16), inp)
        t = precision.conv(_load(nn.Conv2d(3, 96, 16, 16), p),
                           torch.from_numpy(inp).permute(0, 3, 1, 2), bf)
        return j, t.permute(0, 2, 3, 1)
    if name == "conv3d":         # the volume transformer's 3³ convolution
        inp = x(1, 8, 8, 8, 64)
        p, j = flax(fnn.Conv(64, (3, 3, 3), padding="SAME", use_bias=False,
                             dtype=jnp.bfloat16), inp)
        t = precision.conv(_load(nn.Conv3d(64, 64, 3, padding=1, bias=False), p),
                           torch.from_numpy(inp).permute(0, 4, 1, 2, 3), bf)
        return j, t.permute(0, 2, 3, 4, 1)
    if name == "layer_norm":     # on a residual stream with an offset
        inp = x(256, 768, scale=3.0) + 1.0
        p, j = flax(fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16), inp)
        return j, precision.layer_norm(_load(nn.LayerNorm(768, eps=1e-6), p),
                                       torch.from_numpy(inp), bf)
    if name == "gelu":
        inp = x(65536, scale=3.0)
        j = jax.jit(lambda v: fnn.gelu(v.astype(jnp.bfloat16)))(jnp.asarray(inp))
        return (np.asarray(j.astype(jnp.float32)),
                precision.gelu(torch.from_numpy(inp).to(bf)))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["dense", "conv2d", "conv3d", "layer_norm", "gelu"])
def test_precision_helper_matches_flax(name):
    """A bf16 result, bitwise the Flax layer's but for the elements whose
    f32 sums the two packages order differently: at most
    ``HELPER_ULP_SHARE`` of them, each within one bf16 unit in the last
    place at the output's largest magnitude (a sum rounded to the
    neighbouring bf16 value, then a bias that cancels it, leaves that unit
    on a small element)."""
    j, t = _helper_case(name)
    assert t.dtype == torch.bfloat16
    diff = np.abs(j - _t(t))
    share = float((diff > 0).mean())
    ulp = _bf16_ulp(float(np.abs(j).max()))
    print(f"[bf16 helper {name}] {int((diff > 0).sum())} of {diff.size} elements "
          f"differ, by at most {float(diff.max() / ulp):.3f} ulp of max |out|")
    assert diff.max() <= ulp, (name, float(diff.max()), ulp)
    assert share <= HELPER_ULP_SHARE, (name, share)
    if name in ("conv2d", "gelu"):      # no reordered sum: bitwise
        assert share == 0, (name, share)


def test_logits_f32_matches_flax():
    """The attention logits: bf16 operands, an f32 result (JAX's
    ``preferred_element_type=float32``) equal to JAX's up to the order of
    its f32 sum, and not rounded to bf16."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 64, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 80, 4, 64)).astype(np.float32)
    eq = "bqhd,bkhd->bhqk"
    j = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        eq, a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))(q, k))
    t = precision.logits_f32(eq, torch.from_numpy(q).to(torch.bfloat16),
                             torch.from_numpy(k).to(torch.bfloat16))
    assert t.dtype == torch.float32
    t = t.numpy()
    # the exact sum of the bf16 products, and the f32 error a 64-term sum
    # in any order may carry
    qb, kb = (torch.from_numpy(a).to(torch.bfloat16).double().numpy() for a in (q, k))
    exact = np.einsum(eq, qb, kb)
    tol = 64 * np.finfo(np.float32).eps * np.einsum(eq, np.abs(qb), np.abs(kb))
    assert np.all(np.abs(j - exact) <= tol) and np.all(np.abs(t - exact) <= tol)
    rounded = torch.from_numpy(t).to(torch.bfloat16).float().numpy()
    assert float((rounded == t).mean()) < 0.1      # f32, not bf16


def _t(x):
    return x.detach().float().numpy()


def _both_dtypes(jmod_fn, tmod_fn, p, jargs, targs):
    """(JAX f32, JAX bf16, port f32, port bf16) outputs of one module,
    whose port output is f32 in both dtypes (its last layer is f32)."""
    outs = {}
    for jd, td in (F32, BF16):
        outs["j", td] = np.asarray(_apply(jmod_fn(jd), p, *jargs), np.float32)
        with torch.no_grad():
            out = _load(tmod_fn(td), p)(*targs)
        assert out.dtype == torch.float32      # the last layers stay f32
        outs["t", td] = _t(out)
    return (outs["j", torch.float32], outs["j", torch.bfloat16],
            outs["t", torch.float32], outs["t", torch.bfloat16])


def test_vit_block_bf16():
    """One ``ViTBlock``: LayerNorms to bf16, the attention's projections in
    bf16 with f32 logits and softmax, the bf16 GELU MLP, the residual sums
    in bf16 (the token stream is bf16 inside the ViT)."""
    x = _rand(2, 40, 64, seed=1)
    kw = dict(dim=64, num_heads=4)
    p = _np_params(jvit.ViTBlock(**kw), jnp.asarray(x))
    outs = {}
    for jd, td in (F32, BF16):
        outs["j", td] = np.asarray(_apply(jvit.ViTBlock(**kw, dtype=jd), p,
                                          jnp.asarray(x).astype(jd)).astype(jnp.float32))
        with torch.no_grad():
            out = _load(tvit.ViTBlock(**kw, dtype=td), p)(torch.from_numpy(x).to(td))
        assert out.dtype == td
        outs["t", td] = _t(out)
    check_contract("ViTBlock", outs["j", torch.float32], outs["j", torch.bfloat16],
                   outs["t", torch.float32], outs["t", torch.bfloat16], MODULE_RATIO)


def test_vit_bf16():
    img = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    kw = dict(patch_size=16, dim=64, depth=2, num_heads=4)
    p = _np_params(jvit.VisionTransformer(**kw), jnp.asarray(img))
    outs = _both_dtypes(lambda d: jvit.VisionTransformer(**kw, dtype=d),
                        lambda d: tvit.VisionTransformer(**kw, dtype=d), p,
                        (jnp.asarray(img),), (torch.from_numpy(img),))
    check_contract("ViT", *outs, MODULE_RATIO)


def test_vol_transformer_bf16():
    feats = _rand(1, 2, 4, 4, 4, 12, seed=8)
    kw = dict(embed_dim=32, image_feat_dim=12, n_groups=(2,), vol_low_res=4,
              out_dim=16, num_layers=2, num_heads=4)
    p = _np_params(jbb.VolTransformer(**kw), jnp.asarray(feats))
    outs = _both_dtypes(lambda d: jbb.VolTransformer(**kw, dtype=d),
                        lambda d: tbb.VolTransformer(**kw, dtype=d), p,
                        (jnp.asarray(feats),), (torch.from_numpy(feats),))
    check_contract("volume transformer", *outs, MODULE_RATIO)


def test_block_bf16():
    """A point-decoder ``Block``: ``neighbor_conv27`` (one product over the
    27 taps in bf16, f32 accumulation), the windowed attention and the MLP
    in bf16, the residual stream in f32."""
    jps, tps = _serialized(7)
    kw = dict(patch_size=48, order_index=1)
    p = _np_params(jmod.Block(channels=32, num_heads=4, **kw), jps)
    outs = []
    for jd, td in (F32, BF16):
        outs.append(np.asarray(_apply(jmod.Block(channels=32, num_heads=4, dtype=jd,
                                                 **kw), p, jps).feat))
        with torch.no_grad():
            feat = _load(tmod.Block(32, 4, dtype=td, **kw), p)(tps).feat
        assert feat.dtype == torch.float32
        outs.append(_t(feat))
    j32, t32, j16, t16 = outs
    check_contract("Block", j32, j16, t32, t16, MODULE_RATIO)


FWD_KEYS = ("image", "depth", "image_fine", "depth_fine")


@pytest.mark.parametrize("residual", [False, True], ids=["base", "residual"])
def test_whole_network_forward_bf16(residual, monkeypatch):
    """``Network.forward(with_fine=True)`` at the tiny configuration of
    ``tests/test_torch_fine.py`` in both dtypes and both packages: the
    coarse and fine images and depths; in base and in residual attribute
    mode (the evaluation of a residual checkpoint runs at the config's
    bf16)."""
    jb = j_probe(1, 4, 64, 64, 2, seed=0)
    cfg = dict(FINE, enable_residual_attribute=residual)
    p = None
    monkeypatch.setattr(tnet, "compute_neighbor_idx",
                        _jax_neighbor_table(tnet.compute_neighbor_idx))
    outs, scores = {}, {}
    for name, (jd, td) in (("f32", ("float32", torch.float32)),
                           ("bf16", ("bfloat16", torch.bfloat16))):
        jn = jnet.Network(jnet.NetworkConfig(**cfg, drop_path=0.0, backend="xla",
                                             raster_chunk=16, compute_dtype=jd))
        if p is None:
            p = _jax_params(jn, jb, 5)
        jo = jax.jit(lambda p, b: jn.apply(p, b, with_fine=True))(p, jb)
        tn = tnet.Network(tnet.NetworkConfig(**cfg, compute_dtype=jd), device="cpu")
        tn.load_flax_params(p)
        splits = []
        real_split = tnet.topk_split
        monkeypatch.setattr(tnet, "topk_split", lambda s, m, k: splits.append(
            (s, m, k)) or real_split(s, m, k))
        with torch.no_grad():
            to = tn(t_probe(1, 4, 64, 64, 2, seed=0, device="cpu"), with_fine=True)
        monkeypatch.setattr(tnet, "topk_split", real_split)
        assert to["image_fine"].dtype == torch.float32
        outs[name] = ([np.asarray(jo[k]) for k in FWD_KEYS],
                      [_t(to[k]) for k in FWD_KEYS])
        scores[name] = splits[1]
        # the same selection in both packages at this dtype
        np.testing.assert_array_equal(np.asarray(jo["render_pkg"][1][5]),
                                      to["render_pkg"][1][5].numpy())
    for name, (score, valid, k) in scores.items():
        margin = _boundary_margin(score[0].numpy(), valid[0].numpy(), k)
        assert margin > 1e-3 * float(score.max()), (name, margin)
    (j32, t32), (j16, t16) = outs["f32"], outs["bf16"]
    check_contract("whole-network forward", j32, j16, t32, t16, NETWORK_RATIO)


def test_kernel_wrappers_refuse_bf16():
    """The rasterizer stays f32 under the policy: every kernel wrapper
    raises on a bf16 input instead of casting it (the Gaussian heads hand
    the rasterizer f32, ``tests/test_torch_models.py``)."""
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.splat import surfel_kernels as sk

    bf = torch.bfloat16
    ids = torch.zeros(4, dtype=torch.int32)
    tiles = torch.zeros(1, dtype=torch.int32)
    planes = torch.tensor([0.1, 10.0])
    npix = 16 * 16
    calls = {
        "composite_fwd": lambda: kernels.composite_fwd(
            torch.zeros(4, kernels.TABLE_W, dtype=bf), ids, tiles, tiles, 1, 1, 16),
        "composite_bwd": lambda: kernels.composite_bwd(
            torch.zeros(4, kernels.TABLE_W), ids, tiles, tiles,
            torch.zeros(1, 4, npix, dtype=bf), torch.zeros(1, npix), 1, 1, 16,
            "selonly"),
        "surfel_fwd": lambda: sk.surfel_fwd(
            torch.zeros(4, sk.TABLE_W, dtype=bf), ids, tiles, tiles, planes, 1, 1, 16),
        "surfel_bwd": lambda: sk.surfel_bwd(
            torch.zeros(4, sk.TABLE_W, dtype=bf), ids, tiles, tiles, planes,
            None, None, 1, 1, 16, "selonly"),
        "reduce_slots": lambda: kernels.reduce_slots(torch.zeros(8, 10, dtype=bf), 4, 2),
        "transpose_rows": lambda: kernels.transpose_rows(torch.zeros(10, 8, dtype=bf)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="float32"):
            call()

"""PyTorch port vs the JAX package: the coarse model stack with bridged
weights, and the whole coarse ``Network`` at the tiny config of
``__graft_entry__.py``'s dry run.

Flax parameters come from ``jax.eval_shape`` of the module's init, filled
with seeded numpy values (non-trivial LayerNorm scales and biases, so the
weight bridge is exercised leaf by leaf), and reach the port through
``utils.convert.state_dict_from_flax``."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from generativedensification_tpu.data.synthetic import make_probe_batch as j_probe
from generativedensification_tpu.models import backbone as jbb
from generativedensification_tpu.models import network as jnet
from generativedensification_tpu.models import vit as jvit
from generativedensification_torch.data.synthetic import make_probe_batch as t_probe
from generativedensification_torch.models import backbone as tbb
from generativedensification_torch.models import network as tnet
from generativedensification_torch.models import vit as tvit
from generativedensification_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

MODEL_TOL = dict(atol=1e-4, rtol=0)


def _np_params(module, *args, seed=0, method=None, **kw):
    """Flax param tree of ``module`` with seeded numpy values."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "bias":
            v = 0.05 * rng.normal(size=s.shape)
        elif name == "kernel":
            qkv = path[-2].key in ("query", "key", "value")
            fan = s.shape[0] if qkv else int(np.prod(s.shape[:-1]))
            v = rng.normal(size=s.shape) / np.sqrt(fan)
        else:   # positional / view embeddings, CLS token
            v = 0.02 * rng.normal(size=s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(module, params, *args, **kw):
    """``module.apply`` under one jit (non-array arguments static)."""
    static = tuple(i for i, a in enumerate(args) if isinstance(a, (int, float)))
    dyn = [a for a in args if not isinstance(a, (int, float))]

    def fn(p, *d):
        it = iter(d)
        full = [a if i in static else next(it) for i, a in enumerate(args)]
        return module.apply(p, *full, **kw)

    return jax.jit(fn)(params, *dyn)


def _load(tmod, params):
    sd = state_dict_from_flax(params["params"])
    assert set(sd) == set(tmod.state_dict()), set(sd) ^ set(tmod.state_dict())
    tmod.load_state_dict(sd)
    return tmod


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **(tol or MODEL_TOL))


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def test_gelu_is_tanh_approximation():
    x = np.linspace(-3, 3, 301).astype(np.float32)
    _close(fnn.gelu(x), F.gelu(torch.from_numpy(x), approximate="tanh"),
           atol=1e-6, rtol=0)
    # torch's default (erf) form differs by ~4e-4 here: the port must not use it
    diff = np.abs(np.asarray(fnn.gelu(x)) - F.gelu(torch.from_numpy(x)).numpy())
    assert diff.max() > 1e-4


def test_layernorm_eps_is_flax():
    net = tnet.Network(tnet.NetworkConfig(
        encoder_backbone="tiny_test", num_layers=1, embedding_dim=8,
        num_heads=2, view_embed_dim=4, n_groups=(2,), vol_feat_reso=2,
        vol_embedding_reso=2, vol_embedding_out_dim=4), device="cpu")
    eps = {m.eps for m in net.modules() if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {1e-6}


@pytest.mark.parametrize("n_in,n_out", [(14, 32), (14, 4), (14, 14)])
def test_pos_embed_resize_matches_jax_bicubic(n_in, n_out):
    """14->32 (512² input) upsamples, 14->4 (64² test size) downsamples with
    jax.image.resize's antialiasing; F.interpolate differs from both."""
    grid = _rand(n_in, n_in, 8, seed=n_out)
    ref = jax.image.resize(grid[None], (1, n_out, n_out, 8), method="bicubic")[0]
    _close(ref, tvit.resize_bicubic(torch.from_numpy(grid), n_out, n_out))


def test_vit_block():
    x = _rand(2, 17, 32, seed=1)
    jm = jvit.ViTBlock(32, 4)
    p = _np_params(jm, jnp.asarray(x))
    _close(_apply(jm, p, jnp.asarray(x)),
           _load(tvit.ViTBlock(32, 4), p)(torch.from_numpy(x)))


def test_dino_encoder_tiny():
    img = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jvit.DinoEncoder("tiny_test")
    p = _np_params(jm, jnp.asarray(img))
    tm = _load(tvit.DinoEncoder("tiny_test"), p)
    _close(_apply(jm, p, jnp.asarray(img)), tm(torch.from_numpy(img)))


def test_modln_and_bilinear_sample():
    x = _rand(2, 4, 4, 32, seed=3)
    cond = _rand(2, 4, 4, 32, seed=4)
    jm = jbb.ModLN(32)
    p = _np_params(jm, jnp.asarray(x), jnp.asarray(cond))
    tm = _load(tbb.ModLN(32, 32), p)
    _close(_apply(jm, p, jnp.asarray(x), jnp.asarray(cond)),
           tm(torch.from_numpy(x), torch.from_numpy(cond)))
    xy = np.random.default_rng(5).uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32)
    ref = jax.vmap(jbb.bilinear_sample)(jnp.asarray(x), jnp.asarray(xy))
    _close(ref, tbb.bilinear_sample(torch.from_numpy(x), torch.from_numpy(xy)),
           atol=1e-6, rtol=0)
    # the grid_sample(align_corners=False, zeros) contract
    gs = F.grid_sample(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(xy)[:, None], align_corners=False)
    _close(ref, gs[:, :, 0].permute(0, 2, 1), atol=1e-5, rtol=0)


def test_group_att_block():
    x = _rand(1, 8, 8, 8, 32, seed=6)
    cond = _rand(1, 8, 6, 24, seed=7)
    jm = jbb.GroupAttBlock(32, 24, 4)
    p = _np_params(jm, jnp.asarray(x), jnp.asarray(cond), 2, 4)
    tm = _load(tbb.GroupAttBlock(32, 24, 4), p)
    _close(_apply(jm, p, jnp.asarray(x), jnp.asarray(cond), 2, 4),
           tm(torch.from_numpy(x), torch.from_numpy(cond), 2, 4))


def test_vol_transformer():
    feats = _rand(1, 2, 4, 4, 4, 12, seed=8)
    kw = dict(embed_dim=32, image_feat_dim=12, n_groups=(2,), vol_low_res=4,
              out_dim=16, num_layers=2, num_heads=4)
    jm = jbb.VolTransformer(**kw)
    p = _np_params(jm, jnp.asarray(feats))
    tm = _load(tbb.VolTransformer(**kw), p)
    _close(_apply(jm, p, jnp.asarray(feats)), tm(torch.from_numpy(feats)))


def test_gaussian_decoder_coarse_and_fine():
    feats = _rand(2, 40, 16, seed=9)
    pts = _rand(2, 40, 3, 8, seed=10)
    jm = jbb.GaussianDecoder(in_dim=16, sh_dim=12)
    p = _np_params(jm, jnp.asarray(feats), jnp.asarray(pts),
                   method=lambda m, f, q: (m.coarse(f, -2.1792, -3.0), m.fine(f, q)))
    tm = _load(tbb.GaussianDecoder(in_dim=16, sh_dim=12), p)
    jc = _apply(jm, p, jnp.asarray(feats), -2.1792, -3.0, method=jm.coarse)
    tc = tm.coarse(torch.from_numpy(feats), -2.1792, -3.0)
    for a, b in zip(jc, tc):
        _close(a, b)
    jf = _apply(jm, p, jnp.asarray(feats), jnp.asarray(pts), method=jm.fine)
    tf = tm.fine(torch.from_numpy(feats), torch.from_numpy(pts))
    for a, b in zip(jf, tf):
        _close(a, b)


TINY = dict(   # __graft_entry__.py:150-178, coarse part
    n_views=2, encoder_backbone="tiny_test", n_groups=(4,), n_offset_groups=8,
    num_layers=2, num_heads=4, view_embed_dim=8, embedding_dim=32,
    vol_feat_reso=4, vol_embedding_reso=8, vol_embedding_out_dim=16,
    tile_size=16, max_tiles=4, max_per_tile=256,
)


def test_coarse_network_matches_jax():
    """The slice as a whole: ``Network(with_fine=False)`` with JAX params
    bridged, 64², V_total=4, 16 px tiles."""
    jcfg = jnet.NetworkConfig(**TINY, backend="xla", raster_chunk=16)
    jb = j_probe(1, 4, 64, 64, 2, seed=0)
    jn = jnet.Network(jcfg)
    p = _np_params(jn, jb, with_fine=False, seed=11)
    jo = _apply(jn, p, jb, with_fine=False)

    tn = tnet.Network(tnet.NetworkConfig(**TINY), device="cpu")
    tn.load_flax_params(jax.tree.map(np.asarray, p))
    with torch.inference_mode():
        to = tn(t_probe(1, 4, 64, 64, 2, seed=0, device="cpu"))

    assert to["image"].shape == (1, 64, 4 * 64, 3)
    assert to["depth"].shape == (1, 64, 4 * 64, 1)
    assert to["acc_map"].shape == (1, 64, 4 * 64)
    assert float(to["acc_map"].max()) > 0.1
    for k in ("image", "depth", "acc_map"):
        _close(jo[k], to[k], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(np.asarray(jo["overflow"]), to["overflow"].numpy())
    for a, b in zip(jo["render_pkg"][0], to["render_pkg"][0]):
        _close(a, b)


def test_unported_paths_raise():
    """The paths not ported yet raise and name their ROADMAP items:
    evaluation with finetuning (``with_ft``).  The bf16 compute policy, the
    isolated selection closure (``share_selection=False``) and the 2DGS
    renderer are ported and build (``tests/test_torch_bf16.py``,
    ``tests/test_torch_train_select*.py`` and ``tests/test_torch_fine_2dgs.py``
    run them): under bf16 the ViT tokens leave the f32 final LayerNorm and
    the coarse Gaussians the f32 heads."""
    from generativedensification_torch.eval.evaluation import config_from_args, main

    net = tnet.Network(tnet.NetworkConfig(**TINY, share_selection=False), device="cpu")
    assert not net.cfg.share_selection
    bf = tnet.Network(tnet.NetworkConfig(**TINY, compute_dtype="bfloat16"), device="cpu")
    assert bf.cfg.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    with torch.inference_mode():
        out = bf(t_probe(1, 4, 64, 64, 2, seed=0, device="cpu"))
    assert out["image"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in out["render_pkg"][0])
    assert torch.isfinite(out["image"]).all()
    assert tnet.Network(tnet.NetworkConfig(**TINY, renderer="2dgs"),
                        device="cpu").cfg.renderer == "2dgs"
    cfg = config_from_args(["infer.finetuning.with_ft=True",
                            "infer.dataset.dataset_name=synthetic"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(cfg, device="cpu")


def test_weight_bridge_fills_the_fine_tree():
    """``load_flax_params`` on a ``with_fine=True`` tree fills every
    parameter of the port (densifier stages and fine head included) with
    the bridged value, and refuses a tree that lacks one."""
    fine = dict(TINY, k_num=96, dec_depths=(1, 1), dec_channels=(32, 48),
                dec_num_head=(4, 6), non_leaf_ratio=(0.75,), mask_pool=192,
                pdnorm_ln=True)
    jn = jnet.Network(jnet.NetworkConfig(**fine, drop_path=0.0))
    p = jax.tree.map(np.asarray, _np_params(jn, j_probe(1, 4, 64, 64, 2, seed=0),
                                            with_fine=True, seed=12))
    tn = tnet.Network(tnet.NetworkConfig(**fine), device="cpu")
    tn.load_flax_params(p)
    sd = state_dict_from_flax(p["params"])
    own = tn.state_dict()
    assert set(sd) == set(own)
    assert any(k.startswith("stages.1.blocks.0.cpe.") for k in own)
    assert own["stages.0.blocks.0.cpe.weight"].shape == (27, 32, 32)
    assert own["stages.0.blocks.0.norm1.weight"].shape == (3, 32)    # PDNorm
    for k, v in sd.items():
        assert torch.equal(own[k], v), k
    del p["params"]["dec1"]["head"]
    with pytest.raises(KeyError, match="dec|stages.1.head"):
        tnet.Network(tnet.NetworkConfig(**fine), device="cpu").load_flax_params(p)

"""PyTorch port vs the JAX package: the 2DGS surfel serving path
(``tpu.renderer=2dgs``).

The whole ``Network.forward(with_fine=True)`` with bridged weights at the
tiny 2DGS configuration of ``tests/test_network.py:172-182``, and the
evaluation entry point on one tiny synthetic scene, both against JAX on its
XLA backend.  The allowances of ``tests/test_torch_fine.py`` apply (JAX's
co-voxel neighbor representative is substituted, the UpscaleModule's
``delta_x_fc2`` is scaled by 1e-2 in both packages), and the maps are held to
the JAX package's own surfel contract (``tests/test_torch_surfel.py`` says
why it is looser than the 3DGS one).

One more property of the reference shapes the whole-network test (ROADMAP
queue 3).  A surfel seen nearly edge-on has its ray-plane depth
z = det / cr_z at a pixel where cr_z is near 0, while its alpha there is set
by the screen-space filter, which does not see z.  The ~1e-6 differences
between the two networks' coarse attributes (f32 summation order) and the
~1e-4 ones of the fine attributes move cr_z enough to send z from far in
front of the camera (contributing at z >> 1) to behind it (culled by
z > 0.2).  The maps that read z (surface depth, distortion, depth normals)
and every fine map therefore agree at the contract except at isolated
pixels, at most ``KNIFE_EDGE_SHARE`` of them; the image, alpha and rendered
normal of the coarse stage agree everywhere, and
``tests/test_torch_surfel.py`` holds the renderer itself to the contract on
identical inputs."""

import jax
import numpy as np
import torch

from generativedensification_tpu.data.synthetic import make_probe_batch as j_probe
from generativedensification_tpu.models import network as jnet
from generativedensification_torch.data.synthetic import make_probe_batch as t_probe
from generativedensification_torch.models import network as tnet
from generativedensification_torch.splat import kernels
from test_eval import TINY as TINY_OVERRIDES
from test_torch_fine import (
    FINE,
    OPACITY_TOL,
    SCORE_TOL,
    _boundary_margin,
    _jax_neighbor_table,
)
from test_torch_models import _np_params

torch.set_num_threads(1)

# tests/test_network.py:172-182: the fine configuration with one volume
# transformer layer, 4 slots per surfel and the surfel renderer
TINY_2DGS = dict(FINE, num_layers=1, max_tiles=4, renderer="2dgs")
MAP_ATOL = 5e-4       # surfel maps, scaled by max(1, max |map|)
KNIFE_EDGE_SHARE = 5e-3   # pixels a z-sign flip may move beyond MAP_ATOL
# the weights' seed: its selection and opacity-pool boundaries clear their
# tolerances, and no pool point samples a knife-edge pixel of the coarse
# surface depth (with seed 5 one does: its depth feature, and through the
# fine head's unit-scale random weights its fine SH, then differ by ~0.1)
PARAM_SEED = 0


def _jax_params(jn, jb, seed):
    """Seeded numpy params of the JAX network with the densifier's
    coordinate-offset heads scaled by 1e-2 (``tests/test_torch_fine.py``)."""
    p = jax.tree.map(np.asarray, _np_params(jn, jb, with_fine=True, seed=seed))
    for s in ("dec0", "dec1"):
        p["params"][s]["up"]["delta_x_fc2"]["kernel"] *= np.float32(1e-2)
    return p


def _map_close(a, b, name, share=0.0):
    """|b - a| <= MAP_ATOL · max(1, max |a|) except on at most ``share`` of
    the pixels."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(1.0, float(np.abs(a).max()))
    bad = (np.abs(b - a) / scale > MAP_ATOL).reshape(a.shape[:3] + (-1,)).any(-1)
    assert bad.mean() <= share, (name, int(bad.sum()), float(np.abs(b - a).max()))


def test_fine_network_2dgs_matches_jax(monkeypatch):
    """``Network.forward(with_fine=True)`` with ``renderer="2dgs"``: the
    coarse image, alpha and rendered normal at 5e-4 scaled; the surface
    depth, distortion and depth normal, and the fine image, depth and alpha,
    at 5e-4 scaled but for the knife-edge pixels of the module docstring;
    overflow equal, the fine render_pkg at 1e-4 and its validity mask exact,
    and the selected index set identical (the seed leaves the selection
    boundary a margin of more than twice its tolerance)."""
    jcfg = jnet.NetworkConfig(**TINY_2DGS, drop_path=0.0, backend="xla",
                              raster_chunk=16)
    jb = j_probe(1, 4, 64, 64, 2, seed=0)
    jn = jnet.Network(jcfg)
    p = _jax_params(jn, jb, PARAM_SEED)
    jo = jax.jit(lambda p, b: jn.apply(p, b, with_fine=True))(p, jb)

    tn = tnet.Network(tnet.NetworkConfig(**TINY_2DGS), device="cpu")
    tn.load_flax_params(p)
    splits = []
    real_split = tnet.topk_split
    monkeypatch.setattr(tnet, "topk_split",
                        lambda s, m, k: splits.append((s, m, k, real_split(s, m, k)))
                        or splits[-1][3])
    monkeypatch.setattr(tnet, "compute_neighbor_idx",
                        _jax_neighbor_table(tnet.compute_neighbor_idx))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        to = tn(t_probe(1, 4, 64, 64, 2, seed=0, device="cpu"), with_fine=True)
    assert not any(kernels.launch_counts.values())   # CPU: no launch

    (opa, _, k_pool, _), (score, valid, k_sel, (sel_idx, *_)) = splits
    j_opa = 1 / (1 + np.exp(-np.asarray(jo["render_pkg"][0][2], np.float64)))[0, :, 0]
    assert np.abs(j_opa - opa[0].numpy()).max() <= OPACITY_TOL
    margin = _boundary_margin(opa[0].numpy(), np.ones(opa.shape[1], bool), k_pool)
    assert margin > 2 * OPACITY_TOL, f"opacity-pool boundary margin {margin}"
    tol = SCORE_TOL * float(score.max())
    margin = _boundary_margin(score[0].numpy(), valid[0].numpy(), k_sel)
    assert margin > 2 * tol, f"selection boundary margin {margin} <= 2 x {tol}"

    assert to["rend_normal"].shape == (1, 64, 4 * 64, 3)
    assert to["rend_dist"].shape == (1, 64, 4 * 64)
    assert float(to["acc_map"].max()) > 0.5 and float(to["acc_map_fine"].max()) > 0.5
    for k in ("image", "acc_map", "rend_normal"):
        _map_close(jo[k], to[k], k)
    for k in ("depth", "rend_dist", "depth_normal", "image_fine", "depth_fine",
              "acc_map_fine"):
        _map_close(jo[k], to[k], k, share=KNIFE_EDGE_SHARE)
    np.testing.assert_array_equal(np.asarray(jo["overflow"]), to["overflow"].numpy())
    *attrs, ok = to["render_pkg"][1]
    *jattrs, jok = jo["render_pkg"][1]
    np.testing.assert_array_equal(np.asarray(jok), ok.numpy())
    assert int(ok.sum()) > 0
    for a, b, name in zip(jattrs, attrs, ["xyz", "sh", "opacity", "scale", "rotation"]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_evaluation_main_2dgs_matches_jax(tmp_path, monkeypatch):
    """``eval.evaluation.main`` with ``tpu.renderer=2dgs`` on one tiny
    synthetic scene (64²), the port against the JAX ``main`` with the same
    bridged weights: the same JSON keys and per-scene metrics within 1e-3
    (PSNR in dB, SSIM)."""
    from generativedensification_tpu.config import load_config
    from generativedensification_tpu.eval import evaluation as jeval
    from generativedensification_torch.eval import evaluation as teval

    over = TINY_OVERRIDES + [
        "tpu.renderer=2dgs",
        "infer.dataset.dataset_name=synthetic", "infer.dataset.n_scenes=1",
        "infer.dataset.img_size=[64,64]", "infer.save_images=0",
        f"infer.save_folder={tmp_path}",
    ]
    params = {}

    def j_params(cfg, net, batch):
        params["p"] = _jax_params(net, batch, PARAM_SEED)
        return params["p"]

    # the JAX dataset renders through a vmapped rasterizer op by op; one jit
    # of the same function is several times faster
    vmap = jax.vmap
    monkeypatch.setattr(jax, "vmap", lambda f: jax.jit(vmap(f)))
    monkeypatch.setattr(jeval, "load_params", j_params)
    jres = jeval.main(load_config(overrides=over + ["tpu.compute_dtype=float32"],
                                  infer=True))
    monkeypatch.setattr(jax, "vmap", vmap)

    def t_network(cfg, device=None, seed=0):
        net = tnet.Network(cfg, device=device, seed=seed)
        net.load_flax_params(params["p"])
        return net

    monkeypatch.setattr(teval, "Network", t_network)
    monkeypatch.setattr(tnet, "compute_neighbor_idx",
                        _jax_neighbor_table(tnet.compute_neighbor_idx))
    cfg = teval.config_from_args(over + ["tpu.compute_dtype=float32"])
    assert cfg.tpu.renderer == "2dgs"
    tres = teval.main(cfg, device="cpu")
    assert set(tres) == set(jres) == {"mean", "scenes"}
    assert sorted(tres["scenes"]) == sorted(jres["scenes"]) == ["synthetic_0"]
    for scene, rec in jres["scenes"].items():
        assert set(tres["scenes"][scene]) == set(rec)
        for k, v in rec.items():
            assert np.isfinite(tres["scenes"][scene][k])
            assert abs(tres["scenes"][scene][k] - v) <= 1e-3, (k, v)

"""PyTorch port vs the JAX package: per-scene finetuning
(``eval/finetune.py``) and the k-NN scale anchor (``core/knn.py``).

The Adam update against ``optax.adam`` on the same gradients; the render
MSE and its gradients over three steps against JAX ``_ft_step`` and its
loss, on ~2,000 seeded Gaussians at 64² in two views (no network); the
counterpart of ``tests/test_eval.py::test_eval_finetuning_improves_source_mse``
on the port alone; ``mean_knn_sq_dist`` against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from generativedensification_tpu.core.camera import Camera as JCamera
from generativedensification_tpu.core.knn import mean_knn_sq_dist as j_knn
from generativedensification_tpu.eval import finetune as jft
from generativedensification_tpu.splat.rasterizer import rasterize as j_rasterize
from generativedensification_torch.core.camera import Camera as TCamera
from generativedensification_torch.core.knn import mean_knn_sq_dist
from generativedensification_torch.eval import finetune as tft
from test_torch_fine import _scaled_close

torch.set_num_threads(1)

H = W = 64
RASTER = dict(tile_size=16, max_tiles=16, max_per_tile=1024)
LRS = tft.learning_rates()
T = lambda a: torch.from_numpy(np.array(a))


def _scene(n=2000, seed=4):
    """Raw finetunable params (bench-like Gaussians), two cameras facing
    the cloud, seeded target images and backgrounds."""
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    params = {
        "xyz": f(rng.uniform(-0.45, 0.45, size=(n, 3))),
        "sh_dc": shs[:, :1], "sh_rest": shs[:, 1:],
        "opacity": f(rng.normal(size=(n, 1)) - 1.0),
        "scaling": f(rng.uniform(np.log(0.005), np.log(0.02), size=(n, 3))),
        "rotation": f(rng.normal(size=(n, 4))),
    }
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * 2)
    c2ws[:, 2, 3] = -1.9
    c, s = np.cos(0.4), np.sin(0.4)
    c2ws[1, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    gt = f(rng.uniform(size=(2, H, W, 3)))
    bgs = f(rng.uniform(size=(2, 3)))
    return params, c2ws, gt, bgs


def _jax_loss(p, cams, gt, bgs):
    """The loss of JAX ``_ft_step`` (``eval/finetune.py:67-88``)."""
    shs = jnp.concatenate([p["sh_dc"], p["sh_rest"]], axis=1)

    def render_one(cam, bg):
        return j_rasterize(p["xyz"], shs, jax.nn.sigmoid(p["opacity"][:, 0]),
                           jnp.exp(p["scaling"]), p["rotation"], cam, bg, 1,
                           backend="xla", chunk=32, **RASTER).image

    return jnp.mean((jax.vmap(render_one)(cams, bgs) - gt) ** 2)


def test_adam_update_matches_optax():
    """Three updates of every attribute group on seeded gradients (one
    group's gradient zero, another tiny): ``adam_update``'s updates against
    ``optax.adam``'s through the JAX ``_make_tx`` compiled as ``_ft_step``
    compiles it, and the parameters after each update, 1e-7 relative."""
    rng = np.random.default_rng(0)
    shapes = {"xyz": (50, 3), "sh_dc": (50, 1, 3), "sh_rest": (50, 3, 3),
              "opacity": (50, 1), "scaling": (50, 3), "rotation": (50, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.0 if k == "sh_rest" and i == 0 else
                                        1e-9 if k == "rotation" else 1.0)
                  ).astype(np.float32) for k, s in shapes.items()} for i in range(3)]
    tx = jft._make_tx(LRS)

    @jax.jit
    def step(g, s, p):         # _ft_step's update, compiled as one program
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, u

    jp, js = jax.tree.map(jnp.asarray, p0), tx.init(jax.tree.map(jnp.asarray, p0))
    tp = {k: T(v) for k, v in p0.items()}
    ts = tft.init_state(tp)
    for g in grads:
        jp, js, u = step(jax.tree.map(jnp.asarray, g), js, jp)
        tu = tft.adam_update(tp, [T(g[k]) for k, _ in LRS], ts, LRS)
        for k in shapes:
            assert np.abs(np.asarray(u[k])).max() > 0 or k == "sh_rest"
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(u[k]), rtol=1e-7,
                                       atol=0, err_msg=k)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-7,
                                       atol=0, err_msg=k)
    assert ts["count"] == 3


def test_finetune_steps_match_jax():
    """Three steps from the same params: the port's ``ft_step`` trajectory
    against JAX ``_ft_step``'s (loss before each update, 1e-5 relative);
    on JAX's params of each step, the port's loss (1e-5 relative) and every
    attribute's gradient (scaled 5e-5, the gradient contract) against
    ``jax.value_and_grad`` of the same loss."""
    params, c2ws, gt, bgs = _scene()
    jcams = JCamera.from_c2w(jnp.asarray(c2ws), 0.8, 0.8, W, H, znear=0.1, zfar=10.0)
    tcams = TCamera.from_c2w(T(c2ws), 0.8, 0.8, W, H, znear=0.1, zfar=10.0)
    items = tuple(sorted(dict(RASTER, chunk=32, backend="xla").items()))
    jp = jax.tree.map(jnp.asarray, params)
    js = jft._make_tx(LRS).init(jp)
    vg = jax.jit(jax.value_and_grad(_jax_loss))
    tp = {k: T(v) for k, v in params.items()}
    ts = tft.init_state(tp)
    for _ in range(3):
        jl, jg = vg(jp, jcams, jnp.asarray(gt), jnp.asarray(bgs))
        q = {k: T(np.asarray(v)).requires_grad_(True) for k, v in jp.items()}
        tl, overflow = tft.ft_loss(q, tcams, T(gt), T(bgs), 1, RASTER)
        tg = torch.autograd.grad(tl, [q[k] for k, _ in LRS])
        assert int(overflow) == 0
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        for (k, _), g in zip(LRS, tg):
            assert float(np.abs(np.asarray(jg[k])).max()) > 0, k
            _scaled_close(jg[k], g, f"d_{k}")

        jp, js, jloss = jft._ft_step(jp, js, jcams, jnp.asarray(gt), jnp.asarray(bgs),
                                     sh_degree=1, lrs=LRS, raster_items=items)
        tloss, _ = tft.ft_step(tp, ts, tcams, T(gt), T(bgs), sh_degree=1, lrs=LRS,
                               raster_kw=RASTER)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(jloss), float(jl), rtol=1e-5)


def test_finetune_lowers_source_mse_and_init_from_pcd():
    """``init_from_pcd`` (the reference's point-cloud init) against JAX's
    (keys, shapes, the k-NN log scales at 1e-5 relative), then ``finetune``
    from it on the scene's two views: 40 steps lower the loss and move every
    attribute."""
    params, c2ws, gt, bgs = _scene(n=400, seed=9)
    tcams = TCamera.from_c2w(T(c2ws), 0.8, 0.8, W, H, znear=0.1, zfar=10.0)
    rng = np.random.default_rng(2)
    p = tft.init_from_pcd(T(params["xyz"]), T(rng.uniform(0.2, 0.8, (400, 3))
                                              .astype(np.float32)))
    jp = jft.init_from_pcd(jnp.asarray(params["xyz"]),
                           jnp.asarray(rng.uniform(0.2, 0.8, (400, 3)), jnp.float32))
    assert set(p) == set(jp)
    for k in p:
        assert tuple(p[k].shape) == jp[k].shape, k
    # the k-NN distances agree to 1e-6 (below); log and sqrt of the two
    # libraries round differently
    np.testing.assert_allclose(p["scaling"].numpy(), np.asarray(jp["scaling"]), rtol=1e-5)
    loss0, _ = tft.ft_loss(p, tcams, T(gt), T(bgs), 1, RASTER)
    p1, loss = tft.finetune(p, tcams, T(gt), T(bgs), steps=40, raster_kw=RASTER)
    loss1, _ = tft.ft_loss(p1, tcams, T(gt), T(bgs), 1, RASTER)
    assert np.isfinite(loss) and float(loss1) < float(loss0), (float(loss0), float(loss1))
    assert all(not torch.equal(p[k], p1[k]) for k in p)


def test_mean_knn_sq_dist_matches_jax():
    """3,000 seeded points, chunks of 1,024 (a ragged last chunk): 1e-6
    relative against JAX."""
    pts = np.random.default_rng(3).uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    j = np.asarray(jax.jit(lambda x: j_knn(x, chunk=1024))(jnp.asarray(pts)))
    t = mean_knn_sq_dist(T(pts), chunk=1024).numpy()
    assert t.shape == (3000,) and (t > 0).all()
    np.testing.assert_allclose(t, j, rtol=1e-6)

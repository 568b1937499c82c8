"""PyTorch port vs the JAX package: the f32 train step.

The losses (MS-SSIM with its level truncation, the per-prefix MSE + MS-SSIM
and the 2DGS terms on and off) against ``train/loss.py``; the optimizer
against the optax chain of ``train/optim.py`` on the same gradients; the
train-time randomness (drop-path, dropout, order shuffling) with the same
masks or permutation fed to both packages; the eval step; and data
parallelism over two gloo processes against one process at the global
batch.  One whole micro-step against JAX's ``make_train_step`` is in
``tests/test_torch_train_step.py`` (3DGS) and
``tests/test_torch_train_2dgs.py``."""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from generativedensification_tpu.points import modules as jmod
from generativedensification_tpu.points import structure as jst
from generativedensification_tpu.train import loss as jloss
from generativedensification_tpu.train import optim as joptim
from generativedensification_torch.data.synthetic import make_probe_batch as t_probe
from generativedensification_torch.models import network as tnet
from generativedensification_torch.points import modules as tmod
from generativedensification_torch.points import structure as tst
from generativedensification_torch.train import loss as tloss
from generativedensification_torch.train.optim import make_optimizer
from generativedensification_torch.train.state import create_train_state
from generativedensification_torch.train.step import make_eval_step, make_train_step
from test_torch_fine import FINE
from test_torch_train_step import compare_grads

torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a))
LOSS_RTOL = 1e-6          # losses and MS-SSIM, JAX vs the port on one input
GRAD_ATOL = 5e-5          # loss gradients w.r.t. the outputs, scaled


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _loss_inputs(hw, seed, V=2):
    """A smooth target (8 px cells, box-blurred) and renders of it with
    noise: SSIM values of a trained model's order, not of white noise."""
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    tar = np.repeat(np.repeat(rng.uniform(size=(1, V, hw // 8, hw // 8, 3)), 8, 2), 8, 3)
    for axis in (2, 3):
        for _ in range(2):
            tar = (np.roll(tar, 1, axis) + tar + np.roll(tar, -1, axis)) / 3
    tar = f(tar)
    cat = tar.transpose(0, 2, 1, 3, 4).reshape(1, hw, V * hw, 3)
    out = {}
    for prex, noise in (("", 0.08), ("_fine", 0.04)):
        out[f"image{prex}"] = f(np.clip(cat + noise * rng.normal(size=cat.shape), 0, 1))
        out[f"acc_map{prex}"] = f(rng.uniform(size=cat.shape[:3]))
    n = rng.normal(size=cat.shape)
    out["rend_dist"] = f(0.01 * rng.uniform(size=cat.shape[:3]))
    out["rend_normal"] = f(n / np.linalg.norm(n, axis=-1, keepdims=True))
    n2 = n + 0.3 * rng.normal(size=cat.shape)
    out["depth_normal"] = f(n2 / np.linalg.norm(n2, axis=-1, keepdims=True))
    return {"tar_rgb": tar}, out


@pytest.mark.parametrize("hw,step,surfel", [(64, 0, False), (192, 0, False),
                                            (64, 0, True), (64, 2000, True)])
def test_losses_match_jax(hw, step, surfel):
    """``Losses`` (MSE + 0.5·(1 − MS-SSIM) per prefix, the 2DGS terms off
    at step 0 and on at step 2000) and ``ms_ssim`` (3 levels with
    renormalised weights at 64², all 5 at 192²): values within 1e-6
    relative, gradients w.r.t. every output within 5e-5 scaled (measured
    3.7e-5: the SSIM variances E[x²] − E[x]² cancel, and JAX and PyTorch
    round the blur's adjoint differently)."""
    batch, out = _loss_inputs(hw, seed=hw + step)
    if not surfel:
        out = {k: v for k, v in out.items() if not k.startswith(("rend", "depth_n"))}
    keys = sorted(out)

    def jfn(*vals):
        return jloss.Losses()({"tar_rgb": jnp.asarray(batch["tar_rgb"])},
                              dict(zip(keys, vals)), jnp.asarray(step))

    (jl, jstats), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(keys))), has_aux=True))(
            *(jnp.asarray(out[k]) for k in keys))
    tv = [T(out[k]).requires_grad_(True) for k in keys]
    tl, tstats = tloss.Losses()({"tar_rgb": T(batch["tar_rgb"])}, dict(zip(keys, tv)), step)
    tg = torch.autograd.grad(tl, tv, allow_unused=True)
    # the loss holds 0.5·(1 − MS-SSIM) per prefix: where MS-SSIM is near 1
    # its 1e-6 relative is 1e-6 absolute in the loss
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL)
    assert set(tstats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(tstats[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    for k, a, b in zip(keys, jg, tg):
        a = np.asarray(a)
        if not np.abs(a).max():
            assert b is None or float(b.abs().max()) == 0.0, k
            continue
        scale = float(np.abs(a).max())
        np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=GRAD_ATOL,
                                   rtol=0, err_msg=k)
    img1, img2 = out["image"], batch["tar_rgb"].transpose(0, 2, 1, 3, 4).reshape(
        out["image"].shape)
    np.testing.assert_allclose(float(tloss.ms_ssim(T(img1), T(img2))),
                               float(jloss.ms_ssim(jnp.asarray(img1), jnp.asarray(img2))),
                               rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------


def _opt_params(seed):
    """Three named leaves, 50 more of mixed shapes (every second one a
    vector: only the tensors with ndim >= 2 decay) and ``none``, which never
    gets a gradient."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 4),          # decayed
              "b": (4,),            # not decayed
              "c": (2, 3, 3),       # decayed
              "none": (3, 2)}       # no gradient: decays, moments decay
    for i in range(50):
        shapes[f"l{i:02d}"] = [(i % 7 + 1,), (3, i % 5 + 1), (i % 3 + 1, 2, 2),
                               (2 * i + 1,), (1, 1, 2, i % 4 + 1)][i % 5]
    return {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}


def _opt_grads(p0, n_micro, seed=1):
    """Micro-step gradients of every leaf but ``none``: under and over the
    0.5 clip in turn, ``b`` zero on every fourth."""
    rng = np.random.default_rng(seed)
    grads = []
    for i in range(n_micro):
        scale = 0.02 if i % 3 == 0 else 1.0          # under / over the 0.5 clip
        g = {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in p0.items() if k != "none"}
        if i % 4 == 1:
            g["b"] = np.zeros_like(g["b"])
        grads.append(g)
    return grads


def _optax_run(p0, accumulate, **kw):
    """The optax chain of ``make_optimizer`` on ``p0``: ``step(g, skip)``
    takes one micro-step's gradients (zeros for a leaf it lacks) and
    returns the parameters; ``state()`` is optax's state."""
    jparams = jax.tree.map(jnp.asarray, p0)
    tx, _ = joptim.make_optimizer(jparams, accumulate=accumulate, **kw)
    box = {"params": jparams, "state": tx.init(jparams)}

    @jax.jit
    def update(jg, state, params, skip):
        upd, state = tx.update(jg, state, params)
        upd = jax.tree.map(lambda u, gg: jnp.where(jnp.any(gg != 0) | ~skip, u, 0.0), upd, jg)
        return optax.apply_updates(params, upd), state

    def step(g, skip):
        jg = {k: jnp.asarray(g[k]) if k in g else jnp.zeros_like(v)
              for k, v in box["params"].items()}
        box["params"], box["state"] = update(jg, box["state"], box["params"],
                                             jnp.asarray(skip))
        return box["params"]

    return step, lambda: box["state"]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_optimizer_matches_optax(accumulate):
    """``OptaxAdamW`` against ``make_optimizer``'s optax chain on the same
    gradients for 6 updates (warmup of 3 updates, so both schedule branches
    run), with micro-steps whose global norm is above and below the clip,
    on 54 leaves of mixed shapes of which only the matrices decay, one of
    them without a gradient (``.grad`` None against a zero gradient), and
    the coarse-only rule (``skip_zero_grad``, on every second update)
    against the JAX step's ``where(any(g != 0), u, 0)`` on a leaf whose
    gradient is sometimes zero: parameters within 1e-6 relative after
    every micro-step."""
    p0 = _opt_params(0)
    grads = _opt_grads(p0, 6 * accumulate)
    jstep, _ = _optax_run(p0, accumulate, warmup_iters=3)
    tparams = {k: torch.nn.Parameter(T(v)) for k, v in p0.items()}
    opt = make_optimizer(torch.nn.ParameterDict(tparams), warmup_iters=3,
                         accumulate=accumulate)
    moved = 0.0
    for i, g in enumerate(grads):
        skip = (i // accumulate) % 2 == 0
        jparams = jstep(g, skip)
        for k, p in tparams.items():
            p.grad = T(g[k]) if k in g else None
        opt.step(skip_zero_grad=skip)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
        moved = max(moved, float(np.abs(np.asarray(jparams["a"]) - p0["a"]).max()))
    assert opt.count == 6 and moved > 1e-4
    # the leaf without a gradient decayed on the updates that did not skip
    assert float(np.abs(np.asarray(jparams["none"]) - p0["none"]).max()) > 0


@pytest.mark.parametrize("accumulate", [1, 2])
def test_optimizer_state_keyed_by_parameter(accumulate):
    """After every micro-step ``opt.state[p]`` holds ``acc``, ``mu`` and
    ``nu`` for each parameter, as optax's accumulated gradients and first
    and second moments of that leaf (within 1e-6 of the largest value of
    that state over every leaf: the clip's norm, summed in another order
    than optax's, differs in its last bits, and where ``b1 · mu`` and
    ``(1 − b1) · g`` cancel that shows as more than 1e-6 of the small
    result); ``mu`` and
    ``nu`` stay the same tensors across updates (updated in place), and
    ``acc`` is the last gradient without accumulation."""
    p0 = _opt_params(2)
    grads = _opt_grads(p0, 4 * accumulate, seed=3)
    jstep, jstate = _optax_run(p0, accumulate, warmup_iters=3)
    tparams = {k: torch.nn.Parameter(T(v)) for k, v in p0.items()}
    opt = make_optimizer(torch.nn.ParameterDict(tparams), warmup_iters=3,
                         accumulate=accumulate)
    held = {}
    for g in grads:
        jstep(g, False)
        for k, p in tparams.items():
            p.grad = T(g[k]) if k in g else None
        opt.step()
        st = jstate()
        mu, nu = (optax.tree_utils.tree_get(st, name) for name in ("mu", "nu"))
        trees = {"mu": mu, "nu": nu, "acc": getattr(st, "acc_grads", None)}
        scale = {name: max(float(np.abs(np.asarray(v)).max()) for v in tree.values())
                 for name, tree in trees.items() if tree is not None}
        assert set(opt.state) == set(tparams.values())
        for k, p in tparams.items():
            mine = opt.state[p]
            assert set(mine) == {"acc", "mu", "nu"}
            if accumulate > 1:
                theirs = np.asarray(st.acc_grads[k])
                np.testing.assert_allclose(mine["acc"].numpy(), theirs, rtol=1e-6,
                                           atol=1e-6 * scale["acc"], err_msg=k)
            else:
                assert mine["acc"] is p.grad or (p.grad is None and not mine["acc"].any())
            for name, theirs in (("mu", mu[k]), ("nu", nu[k])):
                theirs = np.asarray(theirs)
                np.testing.assert_allclose(mine[name].numpy(), theirs, rtol=1e-6,
                                           atol=1e-6 * scale[name], err_msg=f"{name} {k}")
                assert held.setdefault((k, name), mine[name]) is mine[name]
    assert opt.count == 4


# --------------------------------------------------------------------------
# train-time randomness: the same masks / permutation in both packages
# --------------------------------------------------------------------------


def test_drop_path_and_dropout(monkeypatch):
    """Statistics of the port's draws from an explicit generator (keep
    fraction, scaling by 1/keep, one draw per sample for drop-path, none in
    evaluation or without a rate), and the JAX ``DropPath`` / ``Dropout``
    outputs reproduced exactly when the port is fed JAX's own masks."""
    x = torch.ones((4000, 8))
    gen = torch.Generator().manual_seed(0)
    y = tmod.dropout(x, 0.3, True, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    z = tmod.drop_path(x, 0.25, True, gen)
    per_sample = (z != 0).all(1) | (z == 0).all(1)
    assert per_sample.all() and abs(float((z[:, 0] != 0).float().mean()) - 0.75) < 0.02
    assert torch.equal(tmod.drop_path(x, 0.25, False, gen), x)
    assert torch.equal(tmod.dropout(x, 0.0, True, None), x)
    with pytest.raises(ValueError, match="Generator"):
        tmod.drop_path(x, 0.25, True, None)

    # JAX's masks (read off its outputs: the input has no zeros) fed to the
    # port
    import flax.linen as fnn

    xin = np.random.default_rng(3).normal(size=(16, 10, 4)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(7)}
    jy = np.asarray(jmod.DropPath(0.4).apply({}, jnp.asarray(xin), False, rngs=rngs))
    jmask = jy[:, :1, :1] != 0
    assert 0 < jmask.sum() < 16
    monkeypatch.setattr(tmod, "keep_mask", lambda shape, keep, g, dev: T(jmask))
    np.testing.assert_array_equal(tmod.drop_path(T(xin), 0.4, True, gen).numpy(), jy)
    jd = np.asarray(fnn.Dropout(0.3).apply({}, jnp.asarray(xin), False, rngs=rngs))
    monkeypatch.setattr(tmod, "keep_mask", lambda shape, keep, g, dev: T(jd != 0))
    np.testing.assert_array_equal(tmod.dropout(T(xin), 0.3, True, gen).numpy(), jd)


def test_order_shuffle_matches_jax(monkeypatch):
    """``serialize_pointset(shuffle=perm)`` with JAX's permutation of the
    order slots equals JAX's ``shuffle_key`` serialization exactly, and a
    training ``DensifierStage`` draws its permutation from the generator
    (none in evaluation)."""
    rng = np.random.default_rng(0)
    coord = rng.uniform(-0.45, 0.45, (2, 96, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 96)) > 0.2
    key = jax.random.PRNGKey(11)
    jps = jst.serialize_pointset(jst.PointSet(coord=jnp.asarray(coord),
                                              feat=jnp.zeros((2, 96, 1)),
                                              mask=jnp.asarray(mask), grid_size=1 / 32),
                                 shuffle_key=key)
    perm = np.asarray(jax.random.permutation(key, 4))
    assert (perm != np.arange(4)).any()
    tps = tst.serialize_pointset(tst.PointSet(coord=T(coord), feat=torch.zeros(2, 96, 1),
                                              mask=T(mask), grid_size=1 / 32),
                                 shuffle=T(perm).long())
    np.testing.assert_array_equal(np.asarray(jps.orders), tps.orders.numpy())
    np.testing.assert_array_equal(np.asarray(jps.inverses), tps.inverses.numpy())

    cfg = tnet.NetworkConfig(**FINE, drop_path=0.0)
    stage = tnet.DensifierStage(cfg, 1)
    ps = tst.PointSet(coord=T(coord), feat=T(rng.normal(size=(2, 96, 48)).astype(np.float32)),
                      mask=T(mask), grid_size=1 / 32)
    seen = []
    real = tnet.serialize_pointset
    monkeypatch.setattr(tnet, "serialize_pointset", lambda p, o, shuffle=None:
                        seen.append(shuffle) or real(p, o, shuffle=shuffle))
    stage.eval()
    stage(ps)
    stage.train()
    stage(ps, torch.Generator().manual_seed(1))
    assert seen[0] is None and sorted(seen[1].tolist()) == [0, 1, 2, 3]
    assert cfg.shuffle_orders


# --------------------------------------------------------------------------
# the eval step
# --------------------------------------------------------------------------


def test_eval_step():
    tn = tnet.Network(tnet.NetworkConfig(**FINE), device="cpu")
    tn.train()
    out, stats = make_eval_step(tn)(t_probe(1, 4, 64, 64, 2, seed=0, device="cpu"))
    assert not tn.training and np.isfinite(float(stats["loss"]))
    assert {"mse", "mse_fine", "ssim", "psnr_fine"} <= set(stats)
    assert out["image_fine"].shape == (1, 64, 256, 3)


# --------------------------------------------------------------------------
# data parallelism: two gloo processes at B=1 against one process at B=2
# --------------------------------------------------------------------------

DP_CFG = dict(FINE, drop_path=0.0, shuffle_orders=False)


def _dp_net():
    net = tnet.Network(tnet.NetworkConfig(**DP_CFG), device="cpu", seed=3)
    with torch.no_grad():     # the positional-encoding allowance of test_torch_fine
        for stage in net.stages:
            stage.up.delta_x_fc2.weight.mul_(1e-2)
    return net


def _dp_run(batch):
    """One micro-step (accumulate 2: no parameter moves) -> loss, grads."""
    net = _dp_net()
    opt = make_optimizer(net, accumulate=2)
    st = create_train_state(net, opt)
    st, stats = make_train_step(net, opt, with_fine=True)(st, batch)
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).clone()
             for k, p in net.named_parameters()}
    return float(stats["loss"]), float(stats["overflow"]), grads


def _dp_worker(rank, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        full = t_probe(2, 4, 64, 64, 2, seed=0, device="cpu")
        batch = {k: v[rank:rank + 1] for k, v in full.items()}
        torch.save(_dp_run(batch), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_data_parallel_matches_global_batch(tmp_path):
    """``make_train_step`` under ``torch.distributed`` (gloo, 2 processes,
    B=1 each) gives every process the loss of one process at B=2 within 1e-6
    relative and its gradients within 1e-5 after scaling by their max: the
    global-batch MS-SSIM and MSE of the JAX step, and summed gradients.
    (The gradients of broadcast parameters such as ``view_embed`` are sums
    over the batch and the volume that the two runs add in another order:
    4.5e-6 scaled; ROADMAP queue 3.)"""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dp_worker, args=(port, str(tmp_path)), nprocs=2,
                       start_method="spawn")
    ref_loss, ref_over, ref = _dp_run(t_probe(2, 4, 64, 64, 2, seed=0, device="cpu"))
    for rank in range(2):
        loss, over, grads = torch.load(tmp_path / f"rank{rank}.pt")
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        assert over == ref_over
        compare_grads({k: v.numpy() for k, v in ref.items()},
                      {k: v.numpy() for k, v in grads.items()}, 1e-5)

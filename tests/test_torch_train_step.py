"""PyTorch port vs the JAX package: one whole train micro-step (3DGS).

``make_train_step`` of the port against JAX's ``make_train_step`` with
bridged weights at the tiny configuration of ``tests/test_torch_fine.py``:
the loss within 1e-5 relative and every parameter's gradient within 1e-4
(coarse only) or 1e-3 (with the fine stage) after scaling by its max
|value|.  The helpers serve ``tests/test_torch_train_2dgs.py`` and the
isolated selection closure's ``tests/test_torch_train_select*.py`` too; a
JAX step takes 40-80 s to trace and compile on one CPU core, so at most two
per file.

JAX's gradients are read from ``make_train_step`` itself: its optimizer is
an optax transformation that returns zero updates and keeps the gradients
in its state.  The comparison inherits the allowances of
``tests/test_torch_fine.py`` (JAX's co-voxel neighbor representative is
substituted, the UpscaleModule's ``delta_x_fc2`` is scaled by 1e-2 in both
packages), runs without random draws (drop-path 0, dropout 0, no order
shuffling) and compares the loss and the gradients, not the updated
parameters: in AdamW's first update m̂/√v̂ ≈ sign(g), so a gradient of
~1e-12 in both packages moves a parameter by ±lr either way.  A gradient
that is zero analytically (the ViT attention's key bias: softmax ignores a
constant shift of a query's logits) is rounding noise in both packages, so
it is held to be negligible (``ZERO_GRAD_TOL`` of the step's largest
gradient) in each rather than compared."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativedensification_tpu.data.synthetic import make_probe_batch as j_probe
from generativedensification_tpu.models import network as jnet
from generativedensification_tpu.train import loss as jloss
from generativedensification_tpu.train import state as jstate
from generativedensification_tpu.train import step as jstep
from generativedensification_torch.data.synthetic import make_probe_batch as t_probe
from generativedensification_torch.models import network as tnet
from generativedensification_torch.splat import kernels
from generativedensification_torch.train.optim import make_optimizer
from generativedensification_torch.train.state import create_train_state
from generativedensification_torch.train.step import make_train_step
from generativedensification_torch.utils.convert import state_dict_from_flax
from test_torch_fine import FINE, SCORE_TOL, _boundary_margin, _jax_neighbor_table
from test_torch_fine_2dgs import _jax_params

torch.set_num_threads(1)

STEP_LOSS_RTOL = 1e-5     # the whole step's loss
ZERO_GRAD = ("attn.key.bias",)   # analytically zero gradients (docstring)
ZERO_GRAD_TOL = 1e-6             # of the step's largest gradient


def compare_grads(ref, got, tol):
    """Each parameter's gradient in ``got`` against ``ref`` after scaling
    by its max |value|, within ``tol`` (a number, or a function of the
    parameter's name); the analytically zero ones negligible in both.
    Returns the worst scaled error and the number of live arrays, and
    prints the worst array (``pytest -s`` shows it)."""
    assert set(ref) == set(got)
    gmax = max(float(np.abs(a).max()) for a in ref.values())
    worst, worst_key, n_live = 0.0, None, 0
    for k, a in ref.items():
        b = got[k]
        if k.endswith(ZERO_GRAD):
            for g in (a, b):
                assert float(np.abs(g).max()) <= ZERO_GRAD_TOL * gmax, k
            continue
        scale = float(np.abs(a).max())
        if scale == 0.0:
            assert float(np.abs(b).max()) == 0.0, k
            continue
        n_live += 1
        err = float(np.abs(b - a).max()) / scale
        if err > worst:
            worst, worst_key = err, k
        assert err <= (tol(k) if callable(tol) else tol), (k, err)
    print(f"worst scaled gradient error {worst:.3e} in {worst_key}")
    return worst, n_live


def _grad_recorder():
    """An optax transformation that updates nothing and keeps the gradients
    it is given as its state."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)
    return optax.GradientTransformation(zeros, lambda g, s, params=None: (zeros(g), g))


def run_step_vs_jax(cfg, seed, with_fine, share, step, monkeypatch):
    """One micro-step of both packages on the tiny probe batch (64²,
    V_total = 4); returns the JAX and port stats and gradients (port naming)
    and the selection's boundary margin over its tolerance."""
    jcfg = jnet.NetworkConfig(**cfg, drop_path=0.0, shuffle_orders=False,
                              share_selection=share, backend="xla", raster_chunk=16)
    jb = j_probe(1, 4, 64, 64, 2, seed=0)
    jn = jnet.Network(jcfg)
    p = _jax_params(jn, jb, seed)
    rec = _grad_recorder()
    jfn = jstep.make_train_step(jn, rec, jloss.Losses(), with_fine=with_fine,
                                donate=False)
    js = jstate.TrainState(step=jnp.asarray(step, jnp.int32), params=p,
                           opt_state=rec.init(p), rng=jax.random.PRNGKey(0))
    jnew, jstats = jfn(js, jb)
    jgrads = {k: v.numpy() for k, v in state_dict_from_flax(jnew.opt_state["params"]).items()}

    tn = tnet.Network(tnet.NetworkConfig(**cfg, drop_path=0.0, shuffle_orders=False,
                                         share_selection=share), device="cpu")
    tn.load_flax_params(p)
    splits = []
    real_split = tnet.topk_split
    monkeypatch.setattr(tnet, "topk_split",
                        lambda s, m, k: splits.append((s, m, k)) or real_split(s, m, k))
    monkeypatch.setattr(tnet, "compute_neighbor_idx",
                        _jax_neighbor_table(tnet.compute_neighbor_idx))
    opt = make_optimizer(tn)
    st = create_train_state(tn, opt, seed=0)
    st.step = step
    kernels.reset_launch_counts()
    st, tstats = make_train_step(tn, opt, with_fine=with_fine)(
        st, t_probe(1, 4, 64, 64, 2, seed=0, device="cpu"))
    assert not any(kernels.launch_counts.values())   # CPU: no launch
    assert st.step == step + 1 and opt.count == 1
    tgrads = {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
              for k, v in tn.named_parameters()}
    margin = np.inf
    if with_fine:
        score, valid, k_sel = splits[1]
        tol = SCORE_TOL * float(score.max())
        margin = _boundary_margin(score[0].numpy(), valid[0].numpy(), k_sel) / tol
    return jstats, jgrads, tstats, tgrads, margin


def check_step(jstats, jgrads, tstats, tgrads, margin, grad_tol, stat_rtol=1e-4,
               loss_rtol=STEP_LOSS_RTOL):
    """Loss within ``loss_rtol``, the other stats within ``stat_rtol``, and
    each parameter's gradient within ``grad_tol`` after scaling by its max
    |value| (``compare_grads``; the fine-stage parameters' gradients are zero
    in both without the fine stage).  Returns the worst scaled error."""
    assert margin > 2, f"selection boundary margin {margin:.2f} x its tolerance"
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]),
                               rtol=loss_rtol)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(tstats[k]), float(v), rtol=stat_rtol,
                                   atol=1e-6, err_msg=k)
    worst, n_live = compare_grads(jgrads, tgrads, grad_tol)
    assert n_live > 10
    return worst


@pytest.mark.parametrize("with_fine", [False, True])
def test_train_step_matches_jax(with_fine, monkeypatch):
    """3DGS, at the tiny configuration of ``tests/test_torch_fine.py`` (64²,
    V_total=4, k_num=96) with fused selection: coarse only (gradients 1e-4
    scaled, stats 1e-4 relative) and with the fine stage (1e-3 and 1e-3:
    the fine renders agree to 2e-4, so the SSIM of a ~0.06 value moves by
    ~1e-4 relative)."""
    out = run_step_vs_jax(FINE, 5, with_fine, True, 0, monkeypatch)
    tol = 1e-3 if with_fine else 1e-4
    check_step(*out, grad_tol=tol, stat_rtol=tol)

"""PyTorch port vs the JAX package: one whole 2DGS train micro-step with the
isolated selection closure (``share_selection=False``).

The supervision renders go through the surfel rasterizer while the selection
closure renders the source views again through the 3DGS rasterizer, whose
backward gives the AbsGS channels, as the JAX network does.  The helpers of
``tests/test_torch_train_step.py`` and the depth-pole allowance of
``tests/test_torch_train_2dgs_reg.py``: this selection picks other fine
surfels than the fused one, and the gradients read up to 3.3e-3 scaled
(largest in the densifier's ``delta_x_fc`` layers, which place the fine
surfels; the trunk up to 2.1e-3), against 3.4e-4 for the fused selection
at the same seed."""

from test_torch_fine_2dgs import PARAM_SEED, TINY_2DGS
from test_torch_train_2dgs_reg import POLE_GRAD_TOL
from test_torch_train_step import check_step, run_step_vs_jax


def test_train_step_2dgs_isolated_selection_matches_jax(monkeypatch):
    out = run_step_vs_jax(TINY_2DGS, PARAM_SEED, True, False, 0, monkeypatch)
    check_step(*out, grad_tol=POLE_GRAD_TOL, stat_rtol=1e-3, loss_rtol=1e-4)

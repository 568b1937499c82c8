"""PyTorch port vs the JAX package: one whole train micro-step (2DGS).

The helpers of ``tests/test_torch_train_step.py`` at the tiny 2DGS
configuration of ``tests/test_torch_fine_2dgs.py``, with the 2DGS
regularizers off (step 0): the gradients meet the 3DGS contract, 1e-4
scaled without the fine stage and 1e-3 with it (measured 3.4e-4), the loss
1e-5 relative; the image statistics are held at 1e-3 relative (the surfel
maps' own contract is 5e-4).  The regularizers' case, which needs the
depth-pole allowance, is ``tests/test_torch_train_2dgs_reg.py``."""

import pytest

from test_torch_fine_2dgs import PARAM_SEED, TINY_2DGS
from test_torch_train_step import check_step, run_step_vs_jax


@pytest.mark.parametrize("with_fine", [False, True])
def test_train_step_2dgs_matches_jax(with_fine, monkeypatch):
    """Fused selection, coarse only and with the fine stage.  (The isolated
    selection closure is in ``tests/test_torch_train_select_2dgs.py``.)"""
    out = run_step_vs_jax(TINY_2DGS, PARAM_SEED, with_fine, True, 0, monkeypatch)
    check_step(*out, grad_tol=1e-3 if with_fine else 1e-4, stat_rtol=1e-3)

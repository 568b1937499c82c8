"""PyTorch port vs the JAX package: one whole 3DGS train micro-step with the
isolated selection closure (``share_selection=False``).

The selection scores come from ``torch.autograd.grad`` through a second
render of the source views over zero ``screen_offset`` / ``screen_abs``
inputs (the backward kernel in ``full`` mode).  The helpers and the fine
stage's tolerances of ``tests/test_torch_train_step.py``; the 2DGS case is
``tests/test_torch_train_select_2dgs.py``."""

from test_torch_fine import FINE
from test_torch_train_step import check_step, run_step_vs_jax


def test_train_step_isolated_selection_matches_jax(monkeypatch):
    out = run_step_vs_jax(FINE, 5, True, False, 0, monkeypatch)
    check_step(*out, grad_tol=1e-3, stat_rtol=1e-3)

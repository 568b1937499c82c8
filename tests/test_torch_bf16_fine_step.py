"""PyTorch port vs the JAX package: one tiny train micro-step with the fine
stage (the train CLI's default, ``start_fine`` -1) under the bf16 compute
policy, held to the contract of ``tests/test_torch_bf16.py`` (ROADMAP
queue 3): its loss and its scaled gradients.  The densifier's offset head
feeds the UpscaleModule's 2^14 positional encoding, which amplifies any
rounding that differs there; JAX compiled with XLA's excess precision on
keeps some of that head's bf16 sums in f32, and only compiled without it
does it round where its modules say (and where the port rounds)."""

import torch

from test_torch_bf16 import exact_bf16_jax  # noqa: F401  (autouse fixture)
from test_torch_bf16_step import check_micro_step_bf16

torch.set_num_threads(1)


def test_train_micro_step_bf16_fine(monkeypatch):
    check_micro_step_bf16(True, monkeypatch)

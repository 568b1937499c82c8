"""PyTorch port vs the JAX package: one tiny train micro-step under the
bf16 compute policy, coarse only, held to the contract of
``tests/test_torch_bf16.py`` (ROADMAP queue 3, JAX compiled with XLA's
excess precision off): its loss and its gradients, each scaled by its JAX
f32 max |value|.  Two JAX steps (f32 and bf16) through
``tests/test_torch_train_step.py``'s ``run_step_vs_jax``;
``tests/test_torch_bf16_fine_step.py`` runs the same with the fine stage."""

import numpy as np
import torch

import test_torch_train_step as ts
from test_torch_bf16 import NETWORK_RATIO, check_contract
from test_torch_bf16 import exact_bf16_jax  # noqa: F401  (autouse fixture)
from test_torch_fine import FINE

torch.set_num_threads(1)


def check_micro_step_bf16(with_fine: bool, monkeypatch) -> None:
    """One micro-step in both dtypes and both packages; the contract on the
    loss and on the scaled gradients."""
    runs = {}
    for jd in ("float32", "bfloat16"):
        jstats, jgrads, tstats, tgrads, margin = ts.run_step_vs_jax(
            dict(FINE, compute_dtype=jd), 5, with_fine, True, 0, monkeypatch)
        assert margin > 2, f"selection boundary margin {margin:.2f} x its tolerance"
        runs[jd] = (float(jstats["loss"]), jgrads, float(tstats["loss"]), tgrads)
    j32g = runs["float32"][1]
    keys = [k for k in sorted(j32g) if not k.endswith(ts.ZERO_GRAD)
            and float(np.abs(j32g[k]).max()) > 0]
    assert len(keys) > 10
    scale = {k: float(np.abs(j32g[k]).max()) for k in keys}
    (j32, _, t32, _), (j16, _, t16, _) = runs["float32"], runs["bfloat16"]
    tag = "fine" if with_fine else "coarse"
    check_contract(f"{tag} train loss", [j32], [j16], [t32], [t16], NETWORK_RATIO)
    grads = {jd: ([r[1][k] / scale[k] for k in keys], [r[3][k] / scale[k] for k in keys])
             for jd, r in runs.items()}
    check_contract(f"{tag} train gradients", grads["float32"][0], grads["bfloat16"][0],
                   grads["float32"][1], grads["bfloat16"][1], NETWORK_RATIO)


def test_train_micro_step_bf16(monkeypatch):
    check_micro_step_bf16(False, monkeypatch)

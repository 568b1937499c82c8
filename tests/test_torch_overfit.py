"""The port's quality regression: overfit the tiny network on one synthetic
scene (``generativedensification_torch.tools.overfit``).

Counterpart of ``tests/test_overfit.py``, the JAX package's standing
substitute for scoring the released checkpoints: the same tiny
configuration, the same 64² one-scene ``SyntheticDataset`` batch, step
counts, learning rate, warmup, ``Losses(ssim_levels=2)`` and thresholds,
for the 3DGS, 2DGS and residual attribute cases.  ``slow``, as JAX's is:
the three cases take about 15 minutes on one CPU core.  ``chip_smoke.py``
runs the same three cases on the card."""

import pytest
import torch

from generativedensification_torch.tools import overfit

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


@pytest.mark.parametrize("case", list(overfit.CASES))
def test_overfit_single_scene(case):
    r = overfit.run_case(case, device="cpu")
    print(f"{case}: {r['key']} {r['first']:.2f} -> {r['final']:.2f} in "
          f"{r['steps']} steps, {r['seconds']:.0f}s")
    assert not r["failed"], r["failed"]

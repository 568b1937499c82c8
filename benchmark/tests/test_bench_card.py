"""The comparison that decides ``correct``, on the card at the cells' own
sizes: the control (the plain reference computed one precision below the
configuration's: TF32 matrix products for the serve cells' f32, fp8
products for the train cell's bf16; ``harness/<runner>.py::readings``) put
in the program's place fails a limit, and the program passes them all.

    python -m pytest benchmark/tests -q -m gpu
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4242


def _cell(name):
    return spec.Cell(ROOT, json.loads((ROOT / "BENCHMARK.json").read_text()), name)


def _cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _cells())
def test_control_fails_and_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = _cell(name)
    dev = torch.device("cuda", 0)
    runner = importlib.import_module(f"benchmark.harness.{cell.traffic['runner']}")
    control = runner.readings(cell.config, cell.traffic, SEED, dev, control=True)
    assert any(control[k] > lim for k, lim in cell.limits.items()), control
    sound = runner.readings(cell.config, cell.traffic, SEED, dev, control=False)
    assert all(sound[k] <= lim for k, lim in cell.limits.items()), sound

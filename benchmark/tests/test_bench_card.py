"""The comparison that decides ``correct``, on the card at the cells' own
sizes: the control (the plain reference computed with TF32 matrix
products, the precision below the configurations' f32, put in the
program's place) fails a limit, and the program passes them all.

    python -m pytest benchmark/tests -q -m gpu
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import serve, spec

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
    control = serve.readings(cell.config, cell.traffic, SEED, dev, control=True)
    assert any(v > cell.limits[k] for k, v in control.items()), control
    sound = serve.readings(cell.config, cell.traffic, SEED, dev, control=False)
    assert all(v <= cell.limits[k] for k, v in sound.items()), sound

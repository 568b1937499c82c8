"""The readings the limits of ``limits/<cell>.json`` are set from, in one
process on the card:

    python3 benchmark/readings.py --workload serve.3dgs --seeds 11,12,13 [--control]
    python3 benchmark/readings.py --workload train.3dgs --seeds 11,12 [--fault half]

For each seed, the numbers a run compares on what a run of that seed
checks (``harness/<runner>.py::readings``): of the program (the lower
readings), with ``--control`` of the plain reference computed one
precision below the configuration's (TF32 products for f32, fp8 for bf16)
in the program's place, or with ``--fault`` of the program with a fault
planted (the control and the faults are the upper readings: they have to
fail).  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    import torch

    from benchmark.harness.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(ROOT, json.loads((ROOT / "BENCHMARK.json").read_text()), a.workload)
    runner = importlib.import_module(f"benchmark.harness.{cell.traffic['runner']}")
    kw = {} if a.fault is None else {"fault": a.fault}
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        nums = runner.readings(cell.config, cell.traffic, seed, torch.device("cuda", 0),
                               a.control, **kw)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": a.control,
                          "fault": a.fault,
                          "seconds": time.perf_counter() - t0, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

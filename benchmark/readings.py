"""The readings the limits of ``limits/<cell>.json`` are set from, in one
process on the card:

    python3 benchmark/readings.py --workload serve.3dgs --seeds 11,12,13 [--control]

For each seed, the numbers a run compares on the requests a run of that
seed checks: of the program (the lower readings), or with ``--control`` of
the plain reference computed with TF32 matrix products put in the
program's place (the upper readings: the control has to fail).  One JSON
line per seed.
"""

from __future__ import annotations

import argparse
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
    a = p.parse_args(argv)
    import torch

    from benchmark.harness import serve
    from benchmark.harness.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(ROOT, json.loads((ROOT / "BENCHMARK.json").read_text()), a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        nums = serve.readings(cell.config, cell.traffic, seed, torch.device("cuda", 0),
                              a.control)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": a.control,
                          "seconds": time.perf_counter() - t0, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

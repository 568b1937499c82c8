"""The benchmark of the PyTorch and CUDA port (``generativedensification_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  ``BENCHMARK.json`` names the cell; the
cell names its configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``, whose ``runner`` names the general code in
``harness/`` that drives it); ``limits/<cell>.json`` holds the limits of
the numbers compared against the plain reference; each metric is read by
``metrics/<metric>.py``.  The last line of standard output is the result,
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.

The run exits non-zero and prints no result without enough CUDA devices,
or if JAX or the JAX package is loaded when the window has closed.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(_var, str(ROOT / "build" / _sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.spec import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_PROCESS))

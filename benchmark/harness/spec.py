"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs it, reads its metrics and prints the result line."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

# top-level module names that no run may load: JAX, and the JAX package and
# the scripts that drive it, which this benchmark does not measure
FORBIDDEN = ("jax", "jaxlib", "flax", "generativedensification_tpu", "bench",
             "chip_smoke")
BENCH = Path(__file__).resolve().parents[1]
HOST_THREADS = 2


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, root: Path, spec: dict, name: str, bench: Path = BENCH):
        self.bench = bench
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.cell = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((root / configs[self.cell["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{name}.json").read_text())
        applies = lambda m: "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]


def reader(name: str, bench: Path = BENCH):
    """``metrics/<name>.py``'s ``read``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def finite(x: float) -> float:
    """A number JSON can carry: a non-finite reading becomes 1e300, above
    every limit."""
    return x if math.isfinite(x) else 1e300


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """Run the cell and return the result object."""
    runner = importlib.import_module(f"benchmark.harness.{cell.traffic['runner']}")
    r = runner.run(cell.config, cell.traffic, seed, seconds, trace, device, t_process)
    r.update(cell=cell.name, config=cell.config, traffic=cell.traffic)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.bench)(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: [finite(v), cell.limits[k]] for k, v in r["checks"].items()}
    correct = bool(checks) and set(checks) == set(cell.limits) and all(
        v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _kind(device), "count": cell.cell["chips"],
           "memory_peak_bytes": r["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": r["attempted"], "failed": r["failed"],
           "metrics": metrics, "device": dev}
    if trace and r.get("trace"):
        dev["busy_s"] = r["trace"]["busy_s"]
        dev["window_s"] = r["trace"]["window_s"]
        out["breakdown"] = r["trace"]["breakdown"]
    out["checks"] = checks
    return out


def _kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def latency_quantile(lat: list, q: float) -> float:
    """The q-quantile of the latencies (``statistics.quantiles``,
    inclusive), in seconds; the one latency of a single request."""
    if len(lat) < 2:
        return lat[0]
    return statistics.quantiles(lat, n=100, method="inclusive")[round(q * 100) - 1]


def main(argv, root: Path, t_process: float) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = Cell(root, spec, a.workload)
    import torch

    need = cell.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {need} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    # few host threads: the loop and the prefetch thread share the host
    torch.set_num_threads(HOST_THREADS)
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                   t_process)
    print(f"card: {power_limit()}", file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0

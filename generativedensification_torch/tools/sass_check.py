"""Check that the production forward compositors compile to the same machine
code as a parent commit's sources.

    git archive <parent> generativedensification_torch/csrc | tar -x -C build/parent
    python -m generativedensification_torch.tools.sass_check \\
        --parent build/parent/generativedensification_torch/csrc

Builds ``composite_fwd.cu`` and ``surfel_fwd.cu`` from ``csrc/`` and from
the parent's directory with the port's own ``nvcc`` flags
(``splat/kernels.py::NVCC_FLAGS``), disassembles each library with
``cuobjdump -sass`` and compares every kernel's SASS with its parent's after
dropping the symbol names (which carry the template arguments), kernel by
tile size.  Prints each kernel's ``-Xptxas -v`` line on both sides and
exits 1 if any instruction differs.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``); runs on a machine without a card too.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

from ..splat import kernels

SOURCES = ("composite_fwd", "surfel_fwd")
_OUT = Path(__file__).resolve().parents[2] / "build" / "sass_check"


def _build(src: Path, tag: str) -> tuple[Path, str]:
    _OUT.mkdir(parents=True, exist_ok=True)
    lib = _OUT / f"{tag}_{src.stem}.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def _functions(lib: Path) -> dict[str, list[str]]:
    """SASS per kernel, keyed by the tile size in its symbol, with the
    symbol lines dropped."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = re.search(r"ILi(\d+)E", m.group(1)).group(1)
            funcs[key] = []
        elif key is not None and line.strip():
            funcs[key].append(line.strip())
    return funcs


def _ptxas(log: str) -> dict[str, str]:
    """The ``-Xptxas -v`` report per kernel, keyed by tile size."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = re.search(r"ILi(\d+)E", m.group(1)).group(1)
        elif key is not None and ("registers" in line or "spill" in line):
            out[key] = (out.get(key, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent commit's csrc/ directory")
    args = ap.parse_args(argv)
    here = Path(kernels._CSRC)
    same = True
    for name in SOURCES:
        lib_p, log_p = _build(args.parent / f"{name}.cu", "parent")
        lib_c, log_c = _build(here / f"{name}.cu", "change")
        fp, fc = _functions(lib_p), _functions(lib_c)
        rp, rc = _ptxas(log_p), _ptxas(log_c)
        for ts in sorted(set(fp) | set(fc), key=int):
            a, b = fp.get(ts, []), fc.get(ts, [])
            ok = a == b
            same = same and ok and rp.get(ts) == rc.get(ts)
            n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"{name}_kernel<{ts}>: SASS {'identical' if ok else 'DIFFERS'} "
                  f"({len(a)} / {len(b)} lines, {n_diff} differ)")
            print(f"  parent: {rp.get(ts)}")
            print(f"  change: {rc.get(ts)}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

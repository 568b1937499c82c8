"""Check that the forward compositor bodies that must stay as they were
compile to the same machine code as a parent commit's sources.

    git archive <parent> generativedensification_torch/csrc | tar -x -C build/parent
    python -m generativedensification_torch.tools.sass_check \\
        --parent build/parent/generativedensification_torch/csrc

Builds ``composite_fwd_probe.cu`` and ``surfel_fwd_probe.cu`` (the stage
probes on the one-CTA-per-tile bodies ``composite_fwd.cuh`` and
``surfel_fwd.cuh``, which were kernels #1 and #3 before their sub-tile
redesigns and stay byte for byte) from ``csrc/`` and from the parent's
directory with the port's own ``nvcc`` flags
(``splat/kernels.py::NVCC_FLAGS``), disassembles each library with
``cuobjdump -sass`` and compares every kernel present on both sides, by its
mangled symbol, with its parent's.  ``composite_fwd.cu`` and
``surfel_fwd.cu`` themselves changed on purpose with the redesigns and are
not compared.  Prints
each kernel's ``-Xptxas -v`` line on both sides, lists the kernels only one
side has, and exits 1 if any instruction or report of a shared kernel
differs or the parent has a kernel the change lacks.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``); runs on a machine without a card too.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

from ..splat import kernels

SOURCES = ("composite_fwd_probe", "surfel_fwd_probe")
_OUT = Path(__file__).resolve().parents[2] / "build" / "sass_check"


def _build(src: Path, tag: str) -> tuple[Path, str]:
    _OUT.mkdir(parents=True, exist_ok=True)
    lib = _OUT / f"{tag}_{src.stem}.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def _symbol(mangled: str) -> str:
    """A kernel's mangled symbol without the per-build hash nvcc gives its
    anonymous namespace."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}", r"(anon \1)",
                  mangled)


def _functions(lib: Path) -> dict[str, list[str]]:
    """SASS per kernel, keyed by its mangled symbol, with the symbol lines
    dropped."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = _symbol(m.group(1))
            funcs[key] = []
        elif key is not None and line.strip():
            funcs[key].append(line.strip())
    return funcs


def _ptxas(log: str) -> dict[str, str]:
    """The ``-Xptxas -v`` report per kernel, keyed by its mangled symbol."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = _symbol(m.group(1))
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
        for key in sorted(set(fp) | set(fc)):
            if key not in fp:
                print(f"{name}: {key} is new (not compared)\n  change: {rc.get(key)}")
                continue
            if key not in fc:
                print(f"{name}: {key} is gone")
                same = False
                continue
            a, b = fp[key], fc[key]
            ok = a == b
            same = same and ok and rp.get(key) == rc.get(key)
            n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"{name}: {key}: SASS {'identical' if ok else 'DIFFERS'} "
                  f"({len(a)} / {len(b)} lines, {n_diff} differ)")
            print(f"  parent: {rp.get(key)}")
            print(f"  change: {rc.get(key)}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

"""Check that the production compositor kernels compile to the same machine
code as a parent commit's sources, and print the stage probes' register
reports.

    git archive <parent> generativedensification_torch/csrc | tar -x -C build/parent
    python -m generativedensification_torch.tools.sass_check \\
        --parent build/parent/generativedensification_torch/csrc

Builds the four production libraries of kernels #1-#4
(``composite_fwd.cu``, ``composite_bwd.cu``, ``surfel_fwd.cu``,
``surfel_bwd.cu``, whose bodies ``composite_subtile.cuh`` and
``surfel_subtile.cuh`` the stage probes instantiate too) from ``csrc/`` and
from the parent's directory with the port's own ``nvcc`` flags
(``splat/kernels.py::NVCC_FLAGS``), disassembles each library with
``cuobjdump -sass`` and compares every parent kernel with its counterpart:
the kernel of the same mangled symbol or, where the change gave the
kernel's template more parameters with defaults, the one kernel whose
template arguments extend the parent's.  Prints each kernel's ``-Xptxas -v``
line on both sides and exits 1 if any instruction or report differs, or a
parent kernel has no counterpart.  Then builds the probe libraries
(``composite_fwd_probe.cu``, ``surfel_fwd_probe.cu``) and prints every
variant's ``-Xptxas -v`` line, marking a variant that spills.  Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``); runs on a machine without a card
too.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

from ..splat import kernels

SOURCES = ("composite_fwd", "composite_bwd", "surfel_fwd", "surfel_bwd")
PROBES = ("composite_fwd_probe", "surfel_fwd_probe")
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


_TEMPLATE = re.compile(r"^(.*?)I((?:L[a-z]+n?\d+E)+)E(.*)$")


def _split(key: str):
    """(head, template arguments, tail) of a mangled kernel symbol whose
    template arguments are integer or bool literals; (key, (), "")
    otherwise."""
    m = _TEMPLATE.match(key)
    if not m:
        return key, (), ""
    return m.group(1), tuple(re.findall(r"L[a-z]+n?\d+E", m.group(2))), m.group(3)


def counterpart(key: str, change: dict) -> str | None:
    """The change's kernel for the parent's ``key``: the same symbol, or the
    one kernel of the same name and parameters whose template arguments
    start with the parent's (parameters added with defaults)."""
    if key in change:
        return key
    head, args, tail = _split(key)
    found = []
    for k in change:
        h, a, t = _split(k)
        if (h, t) == (head, tail) and len(a) > len(args) and a[:len(args)] == args:
            found.append(k)
    return found[0] if len(found) == 1 else None


def _spills(report: str | None) -> bool:
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report or "")
    return bool(m) and (m.group(1), m.group(2)) != ("0", "0")


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
        paired = set()
        for key in sorted(fp):
            other = counterpart(key, fc)
            if other is None:
                print(f"{name}: {key} has no counterpart")
                same = False
                continue
            paired.add(other)
            a, b = fp[key], fc[other]
            ok = a == b and rp.get(key) == rc.get(other)
            same = same and ok
            n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"{name}: {key}" + (f" -> {other}" if other != key else "")
                  + f": SASS {'identical' if a == b else 'DIFFERS'} "
                  f"({len(a)} / {len(b)} lines, {n_diff} differ), report "
                  f"{'identical' if rp.get(key) == rc.get(other) else 'DIFFERS'}")
            print(f"  parent: {rp.get(key)}")
            print(f"  change: {rc.get(other)}")
        for key in sorted(set(fc) - paired):
            print(f"{name}: {key} is new (not compared)\n  change: {rc.get(key)}")
    for name in PROBES:
        _, log = _build(here / f"{name}.cu", "change")
        for key, report in sorted(_ptxas(log).items()):
            print(f"{name}: {key}: {report}" + ("  SPILLS" if _spills(report) else ""))
    print(f"production kernels #1-#4: {'identical' if same else 'DIFFER'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

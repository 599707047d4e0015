"""Instruction mix of the hand-written kernels' loops, read from the SASS.

Builds the named kernels (``build.build_all``), disassembles each shared
library with ``cuobjdump -sass`` and prints, for every ``__global__``
function, the opcodes of each loop (a backward branch and the
instructions it jumps over), innermost loops first, with counts by
opcode.  It shows what a loop body costs the card without a profiler:
shared-memory loads (``LDS``, with their width), FP32 operations
(``FFMA``, ``FMUL``, ``FADD``), shuffles (``SHFL``), barriers (``BAR``),
tensor-core products (``HMMA``) and so on.  Run on a machine with the
CUDA toolkit, from the root of a checkout::

    PYTHONPATH=src python -m repro_torch.kernels.sass rwkv6_scan
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import build

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path(build.nvcc_path()).with_name("cuobjdump")
    if default.exists():
        return str(default)
    raise RuntimeError("cuobjdump not found: it ships with the CUDA toolkit")


def parse(sass: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """{function: [(address, opcode, operands), ...]} from cuobjdump's
    text."""
    funcs: Dict[str, List[Tuple[int, str, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def loops(insns: List[Tuple[int, str, str]]) -> List[Tuple[int, int]]:
    """(first, last) instruction index of every backward branch's loop,
    shortest first."""
    index = {addr: i for i, (addr, _, _) in enumerate(insns)}
    found = []
    for i, (_, op, args) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        target = index.get(int(m.group(1), 16)) if m else None
        if target is not None and target < i:
            found.append((target, i))
    return sorted(set(found), key=lambda lo_hi: lo_hi[1] - lo_hi[0])


def report(name: str) -> str:
    build.build_all([name])
    lib = build._target(name)[1]
    sass = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = []
    for func, insns in parse(sass).items():
        out.append(f"{name}: {func}: {len(insns)} instructions")
        for lo, hi in loops(insns):
            mix = collections.Counter(op for _, op, _ in insns[lo:hi + 1])
            counts = ", ".join(f"{op} {n}" for op, n in
                               sorted(mix.items(),
                                      key=lambda kv: (-kv[1], kv[0])))
            out.append(f"  loop [{lo}, {hi}] ({hi - lo + 1} instructions): "
                       f"{counts}")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", default=list(build.KERNELS))
    for name in ap.parse_args().kernels:
        print(report(name), flush=True)


if __name__ == "__main__":
    main()

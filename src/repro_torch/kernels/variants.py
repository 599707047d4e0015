"""Time variants of a hand-written kernel's compile-time constants.

Each variant is the kernel's source with some ``constexpr int NAME = ...;``
lines replaced.  All variants (and the source as it is, ``base``) are built
in parallel with the same ``nvcc`` flags as the kernel itself, each is
checked against the plain version at the slice's shape (the first case of
``chip_smoke.py`` phase 3 for that kernel), and then timed in turns, in
order and in reverse, so that a drift of the card's clock between the
first and the last shows as a spread and not as a difference.  Each time
is taken twice: with the card's queue filled first (device ms: the calls
run back to back, the host's per-call cost hidden) and without
(host-paced ms: what back-to-back calls from Python take).  Run on a
machine with the CUDA toolkit and a card, from the root of a checkout::

    PYTHONPATH=src python -m repro_torch.kernels.variants rwkv6_scan \\
        UNROLL=4 MAX_TC=16,UNROLL=4

It prints one line per variant: its constants, registers and spills (from
ptxas), the max abs error against the plain version, and its times.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.timing import time_ms

VARIANT_DIR = build.BUILD_DIR / "variants"


def slice_case(name: str) -> Tuple[Callable, Callable, tuple, dict]:
    """(wrapper, plain, args, kwargs) at the slice's shape, seeded."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import flash_attention, plain
        args = (randn(4, 256, 28, 128), randn(4, 256, 4, 128),
                randn(4, 256, 4, 128))
        return flash_attention, plain, args, dict(causal=True)
    if name == "rwkv6_scan":
        from repro_torch.kernels.rwkv6_scan import plain, rwkv6_scan
        B, T, H, D = 4, 256, 64, 64
        r, k, v = randn(B, T, H, D), randn(B, T, H, D), randn(B, T, H, D)
        w = randn(B, T, H, D) * 0.5 - 0.5
        u = randn(H, D) * 0.1
        return rwkv6_scan, plain, (r, k, v, w, u, randn(B, H, D, D)), {}
    raise ValueError(f"no slice case for {name!r}")


def variant_source(src: str, consts: Dict[str, str]) -> str:
    for key, value in consts.items():
        pat = re.compile(rf"(constexpr\s+\w+\s+{key}\s*=\s*)[^;]+;")
        if not pat.search(src):
            raise ValueError(f"no constexpr {key} in the source")
        src = pat.sub(rf"\g<1>{value};", src, count=1)
    return src


def parse_variant(text: str) -> Dict[str, str]:
    return dict(item.split("=", 1) for item in text.split(",") if item)


def build_variants(name: str, variants: List[Dict[str, str]]):
    """[(label, library path, ptxas report)], base first."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{name}.cu").read_text()
    jobs = []
    for consts in [{}] + variants:
        label = ",".join(f"{k}={v}" for k, v in consts.items()) or "base"
        fd, cu = tempfile.mkstemp(suffix=".cu", dir=VARIANT_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(variant_source(src, consts))
        lib = cu[:-3] + ".so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, cu]
        jobs.append((label, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                   log)})
        spills = sorted({int(m) for m in re.findall(
            r"(\d+) bytes spill stores", log)})
        out.append((label, lib, f"registers {regs} spill stores {spills}"))
    return out


def run(name: str, variants: List[Dict[str, str]], rounds: int = 2):
    built = build_variants(name, variants)
    wrapper, plain, args, kw = slice_case(name)
    ref = plain(*args, **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    libs = {}
    for label, lib, report in built:
        build._LOADED[name] = libs[label] = ctypes.CDLL(lib)
        got = wrapper(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        print(f"{name} [{label}]: {report}, max_abs_err {err:.3e}",
              flush=True)
    times: Dict[str, List[float]] = {label: [] for label in libs}
    paced: Dict[str, List[float]] = {label: [] for label in libs}
    order = list(libs)
    for i in range(rounds):
        for label in (order if i % 2 == 0 else order[::-1]):
            build._LOADED[name] = libs[label]
            times[label].append(time_ms(lambda: wrapper(*args, **kw), 50,
                                        fill=True))
            paced[label].append(time_ms(lambda: wrapper(*args, **kw), 50))
    build._LOADED.pop(name, None)
    for label, ts in times.items():
        print(f"{name} [{label}]: device ms "
              + " ".join(f"{t:.4f}" for t in ts) + "; host-paced ms "
              + " ".join(f"{t:.4f}" for t in paced[label]), flush=True)
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("flash_attention", "rwkv6_scan"))
    ap.add_argument("variants", nargs="*",
                    help="NAME=VALUE[,NAME=VALUE...] per variant")
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    run(a.kernel, [parse_variant(v) for v in a.variants], a.rounds)


if __name__ == "__main__":
    main()

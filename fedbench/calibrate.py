"""The readings that a cell's limits are set from, on the card.

    python3 -m fedbench.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control 3] [--faults 3] [--out <file.json>]

In one process, for each seed: the program through the checked rounds
(set-up only, no window) and the plain reference after it, and the
compared numbers between them (the lower readings); for the first
``--control`` seeds the reference one precision lower (TF32 on) in the
program's place; for the first ``--faults`` seeds the reference with each
fault of the cell planted (half of each batch left out; one label
altered).  A round left unchanged reads 1 by the measure and needs no
run.  Prints one line a reading and writes them all as JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from fedbench import cells, check, run

FAULTS = ("half_batch", "altered_token")


def _nums(cell, a, b):
    """Every number of ``check.NAMES`` of side ``a`` against ``b``, the
    loss over all checked rounds (``loss``) and over the first
    (``loss_r1``)."""
    n = run.checked_rounds(cell)
    a, b = a.as_dict(), b.as_dict()
    diff = check.diffs(a, b)
    out = check.numbers(a, b, 0, n - 1, diff=diff)
    out["loss_r1"] = check.numbers(a, b, 0, n - 1, loss_rounds=1,
                                   diff=diff)["loss"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", help="default: fedbench/out/cal_<cell>.json")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        pool = run.pool_for(cell, seed, dev)
        prog, state, side = run.program_setup(cell, seed, dev, pool)
        t1 = time.perf_counter()
        del state
        prog.free()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        ref = run.reference_side(cell, seed, dev, pool)
        t2 = time.perf_counter()
        found = [("program", _nums(cell, side, ref))]
        if i < args.control:
            found.append(("control_tf32", _nums(
                cell, run.reference_side(cell, seed, dev, pool, tf32=True),
                ref)))
        if i < args.faults:
            for f in FAULTS:
                found.append((f, _nums(cell, run.reference_side(
                    cell, seed, dev, pool, fault=f), ref)))
        for what, nums in found:
            row = {"seed": seed, "what": what, **nums}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"seed {seed}: program {t1 - t0:.1f} s, reference "
              f"{t2 - t1:.1f} s, all {time.perf_counter() - t0:.1f} s",
              flush=True)
    out = Path(args.out) if args.out else \
        cells.HERE / "out" / f"cal_{args.workload}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    for what in dict.fromkeys(r["what"] for r in rows):
        sel = [r for r in rows if r["what"] == what]
        print(what, {k: (min(r[k] for r in sel), max(r[k] for r in sel))
                     for k in sel[0] if k not in ("seed", "what")},
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

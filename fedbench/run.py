"""Run one cell of the benchmark once.

    python3 -m fedbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up builds the program's round engine
for the cell, makes the weights and the token rows on the card from
``--seed`` and drives the engine through the first rounds, which warm up
every shape and are the rounds the check compares.  The window then runs
whole rounds back to back until ``--seconds`` have passed (a round begun
before the deadline finishes), closed by a synchronise.  After it the
program is freed and the plain reference (``reference/``) runs the
checked rounds again from the same weights and rows.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's rounds), ``failed`` (1 if the state the
window leaves holds a non-finite value), ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, read by
``metrics/<name>.py`` from the profiler's trace of the window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also end standard error.

Without as many CUDA devices as the cell asks for it exits with 2 and
prints no result; with JAX or the JAX package loaded once the window has
closed, with 3.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

_IMPORTED = time.time()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from fedbench import cells, check, counts, traffic, trees  # noqa: E402
from fedbench.program import Program, wrap_fault  # noqa: E402
from fedbench.reference import fedepth, memory, ops  # noqa: E402
from fedbench.tracing import Trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WINDOW_SPAN = "fedbench.window"


def process_start() -> float:
    """The wall-clock time this process started (Linux's ``/proc``, to
    its 10 ms tick), else the time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


class Run:
    """What a per-layer metric reader may read (``metrics/<name>.py``:
    ``read(run) -> float | None``)."""

    def __init__(self, cell, rounds, window_s, trace, host_trace, timers,
                 calls, round_flops):
        self.cell = cell
        self.rounds = rounds            # whole rounds in the window
        self.window_s = window_s        # seconds of the window
        self.trace = trace              # one round, device traced alone
        self.host_trace = host_trace    # one round, host traced too
        self.timers = timers            # program.Timers, one round
        self.calls = calls              # counts.kernel_calls(...)
        self.round_flops = round_flops  # counts.round_flops(...)


class Side:
    """One side's readings of the checked rounds: each step's loss, and
    the state's change after the first and the last checked round, per
    leaf its norm and the change itself (on the host)."""

    def __init__(self, losses, norms, deltas):
        self.losses, self.norms, self.deltas = losses, norms, deltas

    def as_dict(self):
        return {"losses": self.losses, "norms": self.norms,
                "deltas": self.deltas}


def checked_rounds(cell) -> int:
    return int(cell.traffic["checked_rounds"])


def pool_for(cell, seed: int, device):
    return traffic.token_pool(cell.traffic, cell.config.vocab_size,
                              int(cell.traffic["pool_rounds"]), seed,
                              device)


def batch_fn(pool, rd: int):
    rd %= pool.shape[0]
    return lambda k: traffic.batches(pool, rd, int(k))


def initial_state(cell, seed: int, device):
    return cell.family.init(cell.config, traffic.generator(seed, 1, device),
                            device)


def program_setup(cell, seed: int, device, pool, fault=None, marks=None):
    """Build the program, drive it through the checked rounds from the
    seed's weights; returns (program, state, its readings).  ``marks``
    (a list) gains a (what, host clock) pair after each stage."""
    marks = [] if marks is None else marks
    prog = Program(cell, device)
    wrap_fault(prog, fault)
    state = initial_state(cell, seed, device)
    start = trees.flatten(state)
    marks.append(("program and weights", time.time()))
    n = checked_rounds(cell)
    norms, deltas = {}, {}
    prog.probe.active = True
    for rd in range(n):
        state = prog.run_round(state, rd, batch_fn(pool, rd))
        if rd in (0, n - 1):
            deltas[rd] = {}
            norms[rd] = trees.change_norms(trees.flatten(state), start,
                                           deltas[rd])
        marks.append((f"checked round {rd + 1}", time.time()))
    prog.probe.active = False
    keys = list(prog.probe.losses)
    vals = torch.stack(list(prog.probe.losses.values())).tolist() \
        if keys else []
    prog.probe.losses.clear()
    return prog, state, Side(dict(zip(keys, vals)), norms, deltas)


def reference_side(cell, seed: int, device, pool, *, tf32: bool = False,
                   emulate: bool = False, fault=None) -> Side:
    """The reference's readings of the checked rounds, from the same
    seed's weights and rows; ``tf32`` runs it one precision lower (the
    control), ``fault`` breaks its batches as ``program.wrap_fault``
    breaks the program's."""
    fam, cfg, tr = cell.family, cell.config, cell.traffic

    def batches_of(rd, k):
        out = []
        for b in traffic.batches(pool, rd, k):
            tok, lab = b["tokens"], b["labels"]
            if fault == "half_batch":
                tok, lab = tok[:tok.shape[0] // 2], lab[:lab.shape[0] // 2]
            elif fault == "altered_token":
                lab = lab.clone()
                lab[0, 0] = (lab[0, 0] + 1) % cfg.vocab_size
            out.append((tok, lab))
        return out

    n = checked_rounds(cell)
    with ops.precision(tf32, emulate=emulate):
        norms, losses, deltas = fedepth.run_rounds(
            fam, cfg, tr, initial_state(cell, seed, device),
            memory.decompositions(fam, cfg, tr), batches_of, n,
            norm_rounds=(0, n - 1))
    return Side(losses, norms, deltas)


def compare(cell, prog: Side, ref: Side):
    """(correct, ``{name: {value, limit}}``) of the two sides, the
    losses taken as the cell's file says (``loss_rounds``)."""
    n = checked_rounds(cell)
    nums = check.numbers(prog.as_dict(), ref.as_dict(), 0, n - 1,
                         loss_rounds=cell.workload.get("loss_rounds"))
    return check.judge(nums, cell.workload["limits"])


def _traced_round(prog, state, rd, pool, sync, host: bool):
    """One more round under ``torch.profiler``: device activity alone
    (host tracing slows a host-paced round), or with the host's
    operators and launches too.  Returns (state, its Trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            state = prog.run_round(state, rd, batch_fn(pool, rd))
            sync()
        wall = time.perf_counter() - t0
    return state, (Trace.from_profiler(prof, WINDOW_SPAN) if host
                   else Trace.from_profiler(prof, wall_s=wall))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             started: float, fault=None) -> dict:
    """One run of ``cell``; returns the result line as a dict.

    With ``trace`` three more rounds follow the window: one with the
    timers of ``Program.time_calls`` (their synchronises would slow the
    window), one under the profiler tracing the device alone (device
    time, busy and idle seconds), one tracing the host too (what
    launched each kernel, what the host did in each idle gap).  The
    rounds are alike: each runs the same decompositions."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    marks = [("imports", time.time())]
    pool = pool_for(cell, seed, dev)
    marks.append(("CUDA context, token rows", time.time()))
    prog, state, prog_side = program_setup(cell, seed, dev, pool, fault,
                                           marks)
    rd = checked_rounds(cell)
    gc.collect()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - started
    last = started
    stages = []
    for what, t in marks:
        stages.append(f"{what} {t - last:.2f}")
        last = t
    print("set-up (s): " + ", ".join(stages), file=sys.stderr)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    ends = []
    while True:
        state = prog.run_round(state, rd, batch_fn(pool, rd))
        rd += 1
        ends.append(time.perf_counter())
        if ends[-1] >= deadline:
            break
    sync()
    window_s = time.perf_counter() - t0
    rounds = len(ends)
    print("round ends (s, host clock): "
          + " ".join(f"{e - t0:.3f}" for e in ends), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else dev.type, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        values = {"round_s": window_s / rounds, "peak_gib": peak / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": values[cells.base(m.name)],
                               "unit": m.unit}
    else:
        timers = prog.time_calls(sync)
        state = prog.run_round(state, rd, batch_fn(pool, rd))
        timers.freeze()
        dev_tr = host_tr = None
        if cuda:
            state, dev_tr = _traced_round(prog, state, rd + 1, pool, sync,
                                          False)
            state, host_tr = _traced_round(prog, state, rd + 2, pool, sync,
                                           True)
        decomps = memory.decompositions(cell.family, cell.config,
                                        cell.traffic)
        run = Run(cell, rounds, window_s, dev_tr, host_tr, timers,
                  counts.kernel_calls(cell.config, cell.traffic),
                  counts.round_flops(cell.family, cell.config,
                                     cell.traffic, decomps))
        for m in cell.per_layer:
            v = m.reader.read(run)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        if dev_tr is not None:
            device_info["busy_s"] = dev_tr.busy_s()
            device_info["window_s"] = dev_tr.window_s()
            breakdown = {"device_ops": dev_tr.top_device_ops(),
                         "idle_gaps": host_tr.idle_gaps()}
        del dev_tr, host_tr, run
    finite = all(bool(torch.isfinite(t).all())
                 for t in trees.flatten(state).values())

    del state
    prog.free()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_side = reference_side(cell, seed, dev, pool)
    ok, table = compare(cell, prog_side, ref_side)
    result = {"correct": bool(ok and finite), "attempted": rounds,
              "failed": 0 if finite else 1, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    return result


def check_lines(result: dict) -> list:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    cell = cells.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"fedbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), {have} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", started)
    bad = forbidden_modules()
    if bad:
        print(f"fedbench: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

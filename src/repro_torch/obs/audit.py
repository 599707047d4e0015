"""Memory-model conformance auditing (port of ``repro.obs.audit``;
docs/observability.md §Auditing).

FeDepth's premise is that the analytic
:class:`~repro_torch.core.memory_model.ModelMemory` can drive depth-wise
decomposition to fit each client's budget.  This module closes the loop
by measuring what a block step really allocates, per (family, block
[lo, hi), variant, batch) cell, and comparing it with

* the model's prediction — ``block_train_bytes`` rescaled to the batch
  that actually ran (engines price budgets at ``sim.mem_batch`` and train
  at ``sim.batch_size``) plus the frozen full-model parameters the step
  carries — emitted as a ``memory_model_error_ratio`` gauge per cell, and
* every bound client's byte budget whose decomposition contains the
  block — overruns count into ``budget_violations{client_tier=}``.

**What is measured.**  The reference AOT-lowers each block step and reads
XLA's ``memory_analysis()`` (temp + argument + output bytes).  The port
compiles nothing, so it measures the step itself on the card, through
the caching allocator, around the first step of each block
(:func:`cuda_step_memory`):

    measured = (peak allocated during the step - allocated at its start)
               + the bytes of the step's arguments

The first term stands in for XLA's temp and output bytes (the port's step
updates its ``train`` / ``vel`` arguments in place, so no output buffer
is new: ``output_bytes`` is 0); the second for its argument bytes, each
distinct storage counted once.  The measured call IS the run's step —
nothing runs twice, so results are bitwise those of an unaudited run.

Measuring resets the allocator's peak statistic.  The auditor keeps the
running maximum of every peak it erased (:attr:`MemoryAuditor.erased_peak`);
a caller reading a run's peak takes the larger of that and
``torch.cuda.max_memory_allocated()``.

Where there is no CUDA tensor among the step's arguments (a CPU run) the
cell is recorded with ``status="unavailable"``, as the reference does
where its backend has no memory statistics; the auditor never raises
from a measurement.  Cells are deduplicated by (family, lo, hi, variant,
batch), so each is measured once per capture.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: The reference's documented conformance envelope for the analytic
#: model: measured / predicted error ratios of resnet and vit block
#: cells land within these bounds.
ERROR_RATIO_BOUNDS = (0.25, 4.0)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _batch_dim(tree) -> int:
    """Leading dimension of the first tensor leaf (the batch size of a
    batch dict), or 0 when unknown."""
    for leaf in _leaves(tree):
        shape = getattr(leaf, "shape", None)
        if shape:
            return int(shape[0])
    return 0


def argument_bytes(args) -> int:
    """Bytes of the tensors in ``args``, each distinct storage once (a
    FedProx anchor and the parameters it was split from share theirs)."""
    seen: Dict[int, int] = {}
    for t in _leaves(args):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


class _StepFailed(Exception):
    """Carries an error of the audited step itself past the measurement's
    own error handling."""

    def __init__(self, error: Exception):
        super().__init__(str(error))
        self.error = error


class Measurement(dict):
    """What a measurement returns beside the step's output: ``temp``,
    ``argument``, ``output`` and ``code`` bytes (XLA's four fields)."""


def cuda_step_memory(fn: Callable, args: Tuple):
    """Run ``fn(*args)`` once, measuring it through the caching allocator
    of the CUDA device its arguments live on.  Returns ``(out,
    Measurement, erased_peak)``; raises ``RuntimeError`` (before running
    anything) when no argument is a CUDA tensor.  The allocator's
    statistics are host-side counters: nothing here synchronizes the
    device."""
    dev = next((t.device for t in _leaves(args)
                if isinstance(t, torch.Tensor) and t.is_cuda), None)
    if dev is None:
        raise RuntimeError("no CUDA tensor among the step's arguments: "
                           "the caching allocator has no statistics here")
    erased = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    out = fn(*args)
    peak = torch.cuda.max_memory_allocated(dev)
    return out, Measurement(temp=peak - start, argument=argument_bytes(args),
                            output=0, code=0), erased


@dataclasses.dataclass
class AuditCell:
    """One audited (family, block, batch) step."""
    family: str
    lo: int
    hi: int
    variant: str                 # "buffered" | "recompute"
    batch: int
    n_batches: int
    status: str                  # "ok" | "unavailable"
    temp_bytes: Optional[int] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    measured_bytes: Optional[int] = None     # temp + argument + output
    predicted_bytes: Optional[int] = None    # model bytes at this batch
    error_ratio: Optional[float] = None      # measured / predicted
    budget_bytes: Optional[int] = None       # tightest bound budget
    violated_tiers: List[str] = dataclasses.field(default_factory=list)
    detail: str = ""                         # why unavailable, if so

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["block"] = f"{self.lo}:{self.hi}"
        return d


class MemoryAuditor:
    """Measured-vs-predicted memory conformance, one cell per block-step
    signature.  ``bind(ctx)`` attaches the experiment's memory model /
    budgets / decompositions (the engines do this at construction);
    unbound, the auditor still measures and records cells, without
    predictions or budget checks.  ``measure`` (default
    :func:`cuda_step_memory`) is the measurement: a callable ``(fn,
    args) -> (out, Measurement, erased_peak)``."""

    def __init__(self, *, optimizer_slots: int = 2,
                 measure: Optional[Callable] = None):
        self.optimizer_slots = optimizer_slots
        self.measure = measure or cuda_step_memory
        self.cells: Dict[Tuple, AuditCell] = {}
        self.erased_peak = 0
        self._mem = None
        self._ratios = None
        self._budgets = None
        self._decomps = None
        self._metrics = None

    # ---------------------------------------------------------- binding
    def bind(self, ctx, metrics=None) -> "MemoryAuditor":
        """Attach an experiment context (duck-typed: ``.mem``,
        ``.ratios``, ``.budgets``, ``.decomps``) and the capture's
        metrics registry.  Re-binding overwrites."""
        self._mem = getattr(ctx, "mem", None)
        self._ratios = getattr(ctx, "ratios", None)
        self._budgets = getattr(ctx, "budgets", None)
        self._decomps = getattr(ctx, "decomps", None)
        if metrics is not None:
            self._metrics = metrics
        return self

    def reset(self) -> None:
        """Drop recorded cells (bindings survive)."""
        self.cells.clear()

    # ------------------------------------------------------ measurement
    def audit_block_step(self, fn, args: Tuple, *, family: str, lo: int,
                         hi: int, variant: str, n_batches: int = 1):
        """Run one block step, ``fn(*args)``, and return its output —
        measured when its cell is new.  A failed measurement records the
        cell as ``unavailable`` and runs the step plainly; an error of
        the step itself propagates."""
        batch = _batch_dim(args[-1])
        key = (family, lo, hi, variant, batch)
        if key in self.cells:
            return fn(*args)
        cell = AuditCell(family=family, lo=lo, hi=hi, variant=variant,
                         batch=batch, n_batches=n_batches, status="ok")
        self.cells[key] = cell
        ran, out = False, None

        def step(*a):
            nonlocal ran, out
            ran = True
            try:
                out = fn(*a)
            except Exception as e:
                raise _StepFailed(e) from e
            return out

        try:
            _, m, erased = self.measure(step, args)
            self.erased_peak = max(self.erased_peak, int(erased))
            cell.temp_bytes = int(m["temp"])
            cell.argument_bytes = int(m["argument"])
            cell.output_bytes = int(m["output"])
            cell.generated_code_bytes = int(m["code"])
        except _StepFailed as e:
            raise e.error
        except Exception as e:          # no statistics for this device
            cell.status = "unavailable"
            cell.detail = f"{type(e).__name__}: {e}"
            self._count("audit_cells", status="unavailable")
            return out if ran else fn(*args)
        try:
            cell.measured_bytes = (cell.temp_bytes + cell.argument_bytes
                                   + cell.output_bytes)
            self._predict(cell)
            self._check_budgets(cell)
            self._count("audit_cells", status="ok")
        except Exception:   # pragma: no cover — belt and braces
            pass
        return out

    def _predict(self, cell: AuditCell) -> None:
        if self._mem is None or cell.batch <= 0:
            return
        mem = self._mem.rescaled(cell.batch)
        # the step holds one z buffer at a time (the cache's n_batches
        # buffers live outside it), so predict n_batches=1; the frozen
        # full-model parameters ride along as argument bytes
        cell.predicted_bytes = mem.block_train_bytes(
            cell.lo, cell.hi, optimizer_slots=self.optimizer_slots,
            n_batches=1) + mem.param_bytes()
        if cell.predicted_bytes > 0 and cell.measured_bytes is not None:
            cell.error_ratio = cell.measured_bytes / cell.predicted_bytes
            if self._metrics is not None:
                self._metrics.gauge(
                    "memory_model_error_ratio", family=cell.family,
                    block=f"{cell.lo}:{cell.hi}",
                    batch=cell.batch).set(cell.error_ratio)

    def _check_budgets(self, cell: AuditCell) -> None:
        """Measured footprint vs every bound client whose decomposition
        schedules this block.  Budgets are priced at ``sim.mem_batch``
        while the step ran at the training batch: when the training batch
        is smaller, an overrun at pricing scale can go unflagged here."""
        if (self._budgets is None or self._decomps is None
                or cell.measured_bytes is None):
            return
        block = (cell.lo, cell.hi)
        seen: Dict[str, int] = {}
        budget_bound = None
        # by index, not iteration: a population's lazy views have a length
        # but no end to their iteration
        for c in range(len(self._decomps)):
            dec = self._decomps[c]
            if block not in tuple(dec.blocks):
                continue
            budget = int(self._budgets[c])
            budget_bound = budget if budget_bound is None \
                else min(budget_bound, budget)
            if cell.measured_bytes > budget:
                tier = self._tier(c)
                seen[tier] = seen.get(tier, 0) + 1
        cell.budget_bytes = budget_bound
        for tier, n in sorted(seen.items()):
            cell.violated_tiers.append(tier)
            self._count("budget_violations", n, client_tier=tier)

    def _tier(self, client: int) -> str:
        if self._ratios is not None:
            try:
                return f"r{float(self._ratios[client]):g}"
            except Exception:
                pass
        return f"client_{client}"

    def _count(self, name: str, amount: float = 1.0, **labels) -> None:
        if self._metrics is not None:
            self._metrics.counter(name, **labels).inc(amount)

    # ----------------------------------------------------------- views
    def table(self) -> List[dict]:
        """One JSON-able row per audited cell, sorted by (family, lo, hi,
        variant, batch)."""
        return [self.cells[k].row() for k in sorted(self.cells)]

    def query(self, *, family: Optional[str] = None,
              status: Optional[str] = None,
              violated_only: bool = False) -> List[dict]:
        """Filtered view of :meth:`table`."""
        out = []
        for row in self.table():
            if family is not None and row["family"] != family:
                continue
            if status is not None and row["status"] != status:
                continue
            if violated_only and not row["violated_tiers"]:
                continue
            out.append(row)
        return out


__all__ = ["MemoryAuditor", "AuditCell", "ERROR_RATIO_BOUNDS",
           "cuda_step_memory", "argument_bytes"]

"""Memory-adaptive network decomposition (paper §Methodology).

Given the per-unit memory model and a client's budget, produce the block
schedule ``{θ_1..θ_J}``: greedily grow contiguous blocks while the block's
*training* footprint (its params+grads+optimizer state+activations, plus
the always-trained head φ and the buffered input activation z_{lo-1})
stays within budget.  Clients with more memory get fewer/larger blocks —
exactly the paper's Figure 3.

The port's own copy of ``repro.core.decomposition`` (pure Python,
unchanged).

Extreme budgets (paper §Partial Training): if even the finest single-unit
block near the input side exceeds the budget, those leading units are
SKIPPED (never trained locally; richer clients supply them in
aggregation).  If NO unit fits, the client cannot train (raises).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.memory_model import ModelMemory


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Block schedule for one client."""
    blocks: Tuple[Tuple[int, int], ...]   # contiguous (lo, hi) unit ranges
    skipped_prefix: int                   # units never trained (partial)
    budget_bytes: int

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def covers_all(self, n_units: int) -> bool:
        return self.skipped_prefix == 0 and self.blocks and \
            self.blocks[-1][1] == n_units and self.blocks[0][0] == 0


def decompose(mem: ModelMemory, budget_bytes: int, *,
              optimizer_slots: int = 2,
              allow_partial: bool = True,
              n_batches: int = 1) -> Decomposition:
    """Memory-adaptive greedy decomposition.

    ``n_batches`` sizes the buffered z_{lo-1} held per block: the
    paper's accounting (and the protocol default) buffers ONE batch;
    pass the client's distinct-local-batch count to size blocks for the
    prefix cache holding every batch's buffer simultaneously
    (``ModelMemory.block_train_bytes(n_batches=...)`` — see
    docs/prefix_cache.md)."""
    n = len(mem.units)

    def block_cost(lo: int, hi: int) -> int:
        return mem.block_train_bytes(lo, hi, optimizer_slots=optimizer_slots,
                                     n_batches=n_batches)

    # Partial training: skip leading units whose finest block doesn't fit.
    skipped = 0
    if allow_partial:
        while skipped < n and block_cost(skipped, skipped + 1) > budget_bytes:
            skipped += 1
    if skipped == n or (not allow_partial
                        and block_cost(0, 1) > budget_bytes):
        raise MemoryError(
            f"budget {budget_bytes / 2**20:.1f} MiB cannot train any unit "
            f"(finest unit needs "
            f"{min(block_cost(i, i + 1) for i in range(n)) / 2**20:.1f} MiB)")

    blocks: List[Tuple[int, int]] = []
    lo = skipped
    while lo < n:
        if block_cost(lo, lo + 1) > budget_bytes:
            # a MID-network unit that doesn't fit is not coverable by
            # partial training (the paper only skips input-side blocks)
            raise MemoryError(
                f"unit {lo} ({mem.units[lo].name}) needs "
                f"{block_cost(lo, lo + 1) / 2**20:.1f} MiB alone, over the "
                f"{budget_bytes / 2**20:.1f} MiB budget; finest "
                f"decomposition infeasible")
        hi = lo + 1
        while hi < n and block_cost(lo, hi + 1) <= budget_bytes:
            hi += 1
        blocks.append((lo, hi))
        lo = hi
    return Decomposition(tuple(blocks), skipped, budget_bytes)


def width_equivalent_budget(mem: ModelMemory, width_ratio: float, *,
                            optimizer_slots: int = 2) -> int:
    """The paper's budget protocol: a client 'able to train the x r width
    subnetwork' has budget = full-model training memory scaled by the
    width-slimming law (activations ~ r, params ~ r^2)."""
    act = sum(u.activations for u in mem.units) \
        + mem.embed.activations + mem.head.activations
    par = (sum(u.params for u in mem.units) + mem.embed.params
           + mem.head.params) * (2 + optimizer_slots)
    return int(act * width_ratio + par * width_ratio ** 2)


def schedule_summary(dec: Decomposition, mem: ModelMemory,
                     optimizer_slots: int = 2) -> str:
    lines = [f"budget={dec.budget_bytes / 2**20:.1f} MiB, "
             f"skipped_prefix={dec.skipped_prefix}"]
    for lo, hi in dec.blocks:
        cost = mem.block_train_bytes(lo, hi, optimizer_slots=optimizer_slots)
        names = mem.units[lo].name + (f"..{mem.units[hi - 1].name}"
                                      if hi - lo > 1 else "")
        lines.append(f"  block[{lo}:{hi}] ({names}): "
                     f"{cost / 2**20:.1f} MiB")
    return "\n".join(lines)

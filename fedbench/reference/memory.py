"""The budgets and decompositions of a FeDepth round, worked out again.

A frozen copy of the arithmetic the paper's protocol runs on (the port's
``core/memory_model.py``, ``core/decomposition.py`` and the budget part
of ``fl/engine.py``), so that the reference decides for itself which
blocks each client trains.  A unit's parameter and activation counts
come from its family's module (``reference/<family>.py``); the pricing,
the budget protocol and the greedy decomposition are here.

Prices are bytes: parameters in fp32, activations at 2 bytes, a unit
trained with its gradient and two optimizer slots (SGD's fp32 master and
momentum), the head trained with every block and the embedding with the
block at 0.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

SCENARIOS = {
    "fair": (1 / 6, 1 / 3, 1 / 2, 1.0),
    "lack": (1 / 8, 1 / 6, 1 / 2, 1.0),
    "surplus": (1 / 6, 1 / 3, 1 / 2, 2.0),
}
BUDGET_SLACK = 1.20       # the protocol's headroom on a width budget
PARAM_BYTES = 4
ACT_BYTES = 2
TRAIN_COPIES = 4          # parameters + gradients + two optimizer slots


class Cost(NamedTuple):
    params: int           # bytes
    activations: int      # bytes held for the backward


class Memory(NamedTuple):
    units: List[Cost]
    embed: Cost
    head: Cost


class Decomposition(NamedTuple):
    blocks: Tuple[Tuple[int, int], ...]
    skipped: int


def price(fam, cfg, batch: int, seq: int) -> Memory:
    """Every unit, the embedding and the head priced at ``batch`` x
    ``seq`` tokens."""
    n = batch * seq
    out = ACT_BYTES * n * cfg.d_model
    units = [Cost(fam.unit_param_count(cfg) * PARAM_BYTES,
                  fam.unit_act_elems(cfg, n) * ACT_BYTES)
             for _ in range(fam.num_units(cfg))]
    embed = Cost(cfg.vocab_size * cfg.d_model * PARAM_BYTES, out)
    # chunked cross-entropy: one (chunk, V) fp32 tile live, 1/16 of the
    # logits
    head = Cost(fam.head_param_count(cfg) * PARAM_BYTES,
                out + 4 * n * cfg.vocab_size // 16)
    return Memory(units, embed, head)


def _train(c: Cost) -> int:
    return c.params * TRAIN_COPIES + c.activations


def block_bytes(mem: Memory, lo: int, hi: int) -> int:
    """Bytes to train units [lo, hi) with the head (and the embedding
    when the block starts at 0), one batch buffered."""
    b = sum(_train(u) for u in mem.units[lo:hi]) + _train(mem.head)
    return b + (_train(mem.embed) if lo == 0 else 0)


def width_budget(mem: Memory, ratio: float) -> int:
    """A client able to train the x ``ratio`` width network: activations
    scale by the ratio, parameters by its square."""
    act = sum(u.activations for u in mem.units) + mem.embed.activations \
        + mem.head.activations
    par = (sum(u.params for u in mem.units) + mem.embed.params
           + mem.head.params) * TRAIN_COPIES
    return int(act * ratio + par * ratio ** 2)


def decompose(mem: Memory, budget: int) -> Decomposition:
    """Greedy contiguous blocks within ``budget``; leading units whose
    finest block does not fit are skipped (partial training)."""
    n = len(mem.units)
    skipped = 0
    while skipped < n and block_bytes(mem, skipped, skipped + 1) > budget:
        skipped += 1
    if skipped == n:
        raise MemoryError(f"budget {budget} trains no unit")
    blocks, lo = [], skipped
    while lo < n:
        if block_bytes(mem, lo, lo + 1) > budget:
            raise MemoryError(f"unit {lo} alone is over budget {budget}")
        hi = lo + 1
        while hi < n and block_bytes(mem, lo, hi + 1) <= budget:
            hi += 1
        blocks.append((lo, hi))
        lo = hi
    return Decomposition(tuple(blocks), skipped)


def client_ratios(num_clients: int, scenario: str, seed: int) -> np.ndarray:
    """The scenario's ratios over the clients, shuffled by ``seed``."""
    rs = SCENARIOS[scenario]
    reps = int(np.ceil(num_clients / len(rs)))
    arr = np.tile(np.asarray(rs), reps)[:num_clients]
    np.random.default_rng(seed).shuffle(arr)
    return arr


def decompositions(fam, cfg, traffic: dict) -> List[Decomposition]:
    """Each client's blocks under the traffic's scenario, priced at its
    ``mem_batch`` and sequence length."""
    mem = price(fam, cfg, traffic["mem_batch"], traffic["seq_len"])
    floor = min(block_bytes(mem, i, i + 1) for i in range(len(mem.units)))
    out = []
    for r in client_ratios(traffic["num_clients"], traffic["scenario"],
                           traffic["sim_seed"]):
        budget = max(width_budget(mem, min(r, 1.0)) * BUDGET_SLACK, floor)
        out.append(decompose(mem, int(budget)))
    return out

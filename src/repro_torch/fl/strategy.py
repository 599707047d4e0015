"""The ``FLStrategy`` protocol (port of ``repro.fl.strategy``).

Every method is a strategy with four hooks; one ``RoundEngine``
(:mod:`repro_torch.fl.engine`) owns cohort sampling, budget /
decomposition assignment, eval cadence and the structured history.  The
batchable / shardable / async capabilities wait for their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.tree import tree_bytes


@dataclasses.dataclass
class ClientResult:
    """What one client hands back to the server; ``payload`` is
    strategy-defined (the full param tree for FeDepth)."""
    payload: Any
    weight: float                       # aggregation weight ~ |D_k|
    comm_bytes: Optional[int] = None    # upload size; None -> engine sizes
                                        # the payload itself


@dataclasses.dataclass
class Context:
    """Everything the engine precomputes once per experiment and shares
    with the strategy on every hook call.

    ``seed`` seeds the port's own model init (the reference's PRNG key);
    ``device`` is where parameters and data live (the reference's
    ``kernel_force``: the kernels follow the tensors' device).
    ``rng`` is the shared numpy simulation stream, drawn in the
    reference's order so cohorts and batches match it exactly."""
    sim: Any                                 # SimConfig (engine module)
    num_clients: int
    sizes: np.ndarray                        # per-client sample counts
    rng: np.random.Generator                 # shared simulation stream
    seed: int                                # model init seed
    device: torch.device
    model_cfg: Any = None
    mem: Any = None                          # ModelMemory (budget pricing)
    ratios: Optional[np.ndarray] = None      # scenario width ratios
    budgets: Optional[np.ndarray] = None     # bytes per client
    decomps: Optional[List] = None           # Decomposition per client
    data: Any = None
    # depth-wise execution contract: buffer the frozen-prefix activation
    # once per distinct batch per subproblem (True) or replay the prefix
    # in every SGD step (False) — ``RoundEngine(prefix_cache=...)``
    prefix_cache: bool = True


@runtime_checkable
class FLStrategy(Protocol):
    """Protocol every FL method implements.  A strategy may also define
    ``setup(ctx)``, called once before the round loop, also when the
    caller supplies an ``initial_state``."""

    def init_state(self, ctx: Context) -> Any:
        ...

    def client_update(self, ctx: Context, state: Any, client_id: int,
                      batches: Sequence) -> ClientResult:
        ...

    def aggregate(self, ctx: Context, state: Any,
                  results: Sequence[ClientResult]) -> Any:
        ...

    def eval_model(self, ctx: Context, state: Any, x, y) -> float:
        ...


def wire_bytes(tree, *, codec=None) -> int:
    """The sizing rule for payload wire cost: raw bytes of every tensor
    leaf.  Lossy codecs are not ported yet."""
    if codec is not None and codec != "none":
        raise NotImplementedError(f"codec {codec!r} is not ported yet")
    return tree_bytes(tree)

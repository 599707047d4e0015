"""FEDEPTH — Algorithm 1, engine-backed (port of ``repro.core.fedepth``).

``FedepthServer`` is a thin facade over the shared
:class:`repro_torch.fl.engine.RoundEngine` driving
:class:`repro_torch.fl.strategies.fedepth.FedepthStrategy` with an
explicit ``BlockRunner`` — the same engine and strategy the registered
image path uses.  Variants:
  * head="skip"  -> FEDEPTH           (skip-connection classifier)
  * head="aux"   -> m-FEDEPTH         (auxiliary classifiers)
  * clients with surplus budget       -> MKD local update (core.mkd)
  * clients below the finest block    -> partial training (skip prefix)

Model- and optimizer-agnostic: anything with a BlockRunner works, and the
local solver is plain SGD-momentum (optionally FedProx via ``prox_mu``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.blockwise import BlockRunner
from repro_torch.core.decomposition import Decomposition, decompose
from repro_torch.core.memory_model import ModelMemory
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ClientSpec:
    """One client's capability + data."""
    client_id: int
    budget_bytes: int
    n_samples: int
    surplus_models: int = 1   # M > 1 -> MKD locally


@dataclasses.dataclass
class FedepthConfig:
    rounds: int = 10
    participation: float = 0.1
    lr: float = 0.1
    momentum: float = 0.9
    local_steps: int = 1
    head: str = "skip"          # "skip" -> FeDepth, "aux" -> m-FeDepth
    prox_mu: float = 0.0
    masked_aggregation: bool = False  # beyond-paper refinement
    seed: int = 0


class FedepthServer:
    """Server orchestration (Algorithm 1) over the shared round engine,
    on ``device`` (the GPU unless ``"cpu"``)."""

    def __init__(self, runner: BlockRunner, mem: ModelMemory,
                 clients: Sequence[ClientSpec], cfg: FedepthConfig,
                 *, mkd_fns=None, device: DeviceLike = None):
        from repro_torch.fl.engine import RoundEngine, SimConfig
        from repro_torch.fl.strategies.fedepth import FedepthStrategy
        from repro_torch.fl.strategy import Context

        self.runner = runner
        self.mem = mem
        self.clients = list(clients)
        self.cfg = cfg
        # precompute each client's decomposition (paper: before training)
        self.decomps: Dict[int, Decomposition] = {
            c.client_id: decompose(mem, c.budget_bytes) for c in clients}

        strategy = FedepthStrategy(
            head=cfg.head, runner=runner, mkd_fns=mkd_fns,
            masked_aggregation=cfg.masked_aggregation, prox_mu=cfg.prox_mu)
        sim = SimConfig(rounds=cfg.rounds, participation=cfg.participation,
                        lr=cfg.lr, momentum=cfg.momentum,
                        local_steps=cfg.local_steps, seed=cfg.seed)
        ctx = Context(
            sim=sim, num_clients=len(self.clients),
            sizes=np.array([c.n_samples for c in self.clients], np.float64),
            rng=np.random.default_rng(cfg.seed), seed=cfg.seed,
            device=resolve_device(device), mem=mem,
            budgets=np.array([c.budget_bytes for c in self.clients]),
            decomps=[self.decomps[c.client_id] for c in self.clients],
            surplus=np.array([c.surplus_models for c in self.clients]))
        self.engine = RoundEngine(strategy, ctx)

    def round(self, global_params, client_batches: Callable,
              round_idx: int = 0):
        """One communication round.  ``client_batches(client_id)`` yields
        that client's local batch list."""
        state, _up, _down = self.engine.run_round(
            global_params, round_idx, self._batch_fn(client_batches))
        return state

    def fit(self, global_params, client_batches: Callable,
            eval_fn: Optional[Callable] = None, log_every: int = 1):
        return self.engine.run(initial_state=global_params,
                               batch_fn=self._batch_fn(client_batches),
                               eval_fn=eval_fn, eval_every=log_every)

    def _batch_fn(self, client_batches: Callable) -> Callable:
        # positional ids map 1:1 onto ClientSpec.client_id via list order
        return lambda idx: client_batches(self.clients[idx].client_id)

"""The system under test: ``repro_torch``'s round engine on a cell.

The benchmark hands the program its weights and batches and takes from
it only what the timed path produces: the server state after each round,
the loss of each block step (read through a wrapper on the strategy's
runner), and, in a traced run, the seconds of each client update and
aggregate (wrappers on the engine's strategy instance).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def model_config(cfg):
    """The program's ``ModelConfig`` from a configuration file's keys."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in vars(cfg).items()
                          if k in names})


class Probe:
    """Per-step losses of the rounds being checked, keyed by (round,
    client, step) as device scalars; off, the wrapper passes through."""

    def __init__(self):
        self.active = False
        self.round = self.client = -1
        self.step = 0
        self.losses: Dict[tuple, torch.Tensor] = {}

    def record(self, loss: torch.Tensor) -> None:
        if self.active:
            self.losses[(self.round, self.client, self.step)] = \
                loss.detach()
            self.step += 1


class Timers:
    """A traced run's per-call times: each client update on the host
    clock closed by a synchronise, each aggregate between CUDA events."""

    def __init__(self, sync: Callable[[], None], cuda: bool):
        self.sync, self.cuda = sync, cuda
        self.client_s: List[float] = []
        self._aggregates: list = []
        self.frozen = False

    def freeze(self) -> None:
        """Stop recording (the window has closed)."""
        self.frozen = True

    def aggregate_ms(self) -> List[float]:
        if not self.cuda:
            return []
        self.sync()
        return [a.elapsed_time(b) for a, b in self._aggregates]


class Program:
    """One engine, strategy and context for a cell, on ``device``."""

    def __init__(self, cell, device: str):
        from repro_torch.fl.engine import RoundEngine, SimConfig
        from repro_torch.fl.registry import get_strategy
        from repro_torch.fl.seq import FederatedSeqData, build_lm_context
        tr = cell.traffic
        self.device = torch.device(device)
        self.model_cfg = model_config(cell.config)
        per_client = tr["batches_per_client"] * tr["batch_size"]
        sim = SimConfig(rounds=1, participation=tr["participation"],
                        lr=tr["lr"], momentum=tr["momentum"],
                        local_steps=tr["local_steps"],
                        batch_size=tr["batch_size"],
                        mem_batch=tr["mem_batch"], scenario=tr["scenario"],
                        seed=tr["sim_seed"])
        T = tr["seq_len"]
        # the context takes the data's sequence length and client sizes;
        # the batches themselves come from the benchmark's ``batch_fn``
        blank = torch.zeros(1, T, dtype=torch.int64, device=self.device)
        data = FederatedSeqData(
            torch.zeros(0, T + 1, dtype=torch.int64, device=self.device),
            [np.arange(k * per_client, (k + 1) * per_client)
             for k in range(tr["num_clients"])],
            blank, blank, self.model_cfg.vocab_size)
        self.ctx = build_lm_context(data, sim, self.model_cfg,
                                    device=self.device)
        self.strategy = get_strategy(tr["strategy"])
        self.strategy.head = tr["head"]
        self.strategy.setup(self.ctx)
        self.engine = RoundEngine(self.strategy, self.ctx,
                                  scheduler=tr["scheduler"],
                                  prefix_cache=tr["prefix_cache"],
                                  codec=tr["codec"])
        self.remat = tr["remat"]
        self.probe = Probe()
        self._wrap_losses()

    def _wrap_losses(self) -> None:
        runner, probe = self.strategy.runner, self.probe
        head_loss = runner.head_loss

        def recorded(params, z, batch, block_idx):
            loss = head_loss(params, z, batch, block_idx)
            probe.record(loss)
            return loss

        self.strategy.runner = dataclasses.replace(runner,
                                                   head_loss=recorded)
        update = self.strategy.client_update

        def client_update(ctx, state, client_id, batches):
            probe.client, probe.step = int(client_id), 0
            return update(ctx, state, client_id, batches)

        self.strategy.client_update = client_update

    def run_round(self, state, rd: int, batch_fn):
        from repro_torch.models.common import disable_remat
        self.probe.round = rd
        if self.remat:
            return self.engine.run_round(state, rd, batch_fn)[0]
        with disable_remat():
            return self.engine.run_round(state, rd, batch_fn)[0]

    def time_calls(self, sync: Callable[[], None]) -> Timers:
        """Wrap the strategy's client update and aggregate with timers
        (for a round after the window: the synchronise around each client
        update keeps the host from running ahead)."""
        timers = Timers(sync, self.device.type == "cuda")
        update, aggregate = self.strategy.client_update, \
            self.strategy.aggregate

        def client_update(ctx, state, client_id, batches):
            with torch.profiler.record_function("fedbench.client_update"):
                if timers.frozen:
                    return update(ctx, state, client_id, batches)
                sync()
                t0 = time.perf_counter()
                out = update(ctx, state, client_id, batches)
                sync()
                timers.client_s.append(time.perf_counter() - t0)
            return out

        def timed_aggregate(ctx, state, results):
            with torch.profiler.record_function("fedbench.aggregate"):
                if timers.frozen or not timers.cuda:
                    return aggregate(ctx, state, results)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = aggregate(ctx, state, results)
                b.record()
                timers._aggregates.append((a, b))
            return out

        self.strategy.client_update = client_update
        self.strategy.aggregate = timed_aggregate
        return timers

    def free(self) -> None:
        """Drop the engine, its context and the wrappers (they tie the
        strategy into reference cycles)."""
        self.engine = self.ctx = self.strategy = None


def wrap_fault(program: Program, fault: Optional[str]) -> None:
    """Break the timed path for a test of the check: ``"unchanged"``
    (a round returns its state unchanged), ``"half_batch"`` (each client
    trains on the first half of its rows, the mean over them) or
    ``"altered_token"`` (one label of each batch off by one where the
    loss reads it)."""
    if fault is None:
        return
    s = program.strategy
    update = s.client_update
    if fault == "unchanged":
        s.aggregate = lambda ctx, state, results: state
        return
    if fault == "half_batch":
        def alter(b):
            return {k: v[:v.shape[0] // 2] for k, v in b.items()}
    elif fault == "altered_token":
        def alter(b):
            labels = b["labels"].clone()
            labels[0, 0] = (labels[0, 0] + 1) % program.model_cfg.vocab_size
            return {**b, "labels": labels}
    else:
        raise ValueError(f"unknown fault {fault!r}")

    def broken(ctx, state, client_id, batches):
        return update(ctx, state, client_id, [alter(b) for b in batches])
    s.client_update = broken

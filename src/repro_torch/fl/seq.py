"""Federated sequence-model (LM) tasks + the context they run in (port of
``repro.fl.seq``).

Synthetic next-token task ``x_{t+1} = pi(x_t)`` with probability
``1 - noise``, else uniform, for a fixed random permutation ``pi``: any
model that learns the bigram map reaches ~``(1 - noise)`` accuracy; chance
is ``1 / vocab``.  Tokens are drawn with numpy exactly as the reference
draws them, then live on the device; client batches are chosen with the
shared numpy stream in the reference's order and gathered on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blockwise import lm_prefix_stable
from repro_torch.core.decomposition import decompose
from repro_torch.core.memory_model import lm_memory
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.engine import SimConfig, client_ratios, scenario_budgets
from repro_torch.fl.strategy import Context


@dataclasses.dataclass
class FederatedSeqData:
    """IID token shards over a shared ``(N, T+1)`` sequence tensor on the
    device; ``x_test`` / ``y_test`` are the pre-shifted eval split."""
    seqs: torch.Tensor                # (N, T+1) int64, on the device
    client_indices: List[np.ndarray]
    x_test: torch.Tensor              # (M, T) inputs
    y_test: torch.Tensor              # (M, T) next-token labels
    vocab_size: int

    @property
    def device(self) -> torch.device:
        return self.seqs.device

    def client_batch(self, k: int, batch_size: int,
                     rng: np.random.Generator):
        idx = self.client_indices[k]
        take = rng.choice(idx, size=min(batch_size, len(idx)), replace=False)
        seq = self.seqs[torch.as_tensor(take, device=self.device)]
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def client_sizes(self) -> np.ndarray:
        return np.array([len(i) for i in self.client_indices])


def synth_tokens(n: int, vocab_size: int = 32, seq_len: int = 16,
                 noise: float = 0.1, seed: int = 0,
                 stream: int = 0) -> np.ndarray:
    """``(n, seq_len+1)`` noisy-successor sequences (numpy, identical to
    the reference's draws)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17, stream]))
    pi = np.random.default_rng(seed).permutation(vocab_size)
    toks = np.empty((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, size=n)
    for t in range(1, seq_len + 1):
        corrupt = rng.random(n) < noise
        toks[:, t] = np.where(corrupt, rng.integers(0, vocab_size, size=n),
                              pi[toks[:, t - 1]])
    return toks


def build_seq_data(num_clients: int, *, n_per_client: int = 64,
                   n_test: int = 256, vocab_size: int = 32,
                   seq_len: int = 16, noise: float = 0.1, seed: int = 0,
                   device: DeviceLike = None) -> FederatedSeqData:
    dev = resolve_device(device)
    train = synth_tokens(num_clients * n_per_client, vocab_size, seq_len,
                         noise, seed, stream=0)
    test = synth_tokens(n_test, vocab_size, seq_len, noise, seed, stream=1)
    idx = np.arange(len(train))
    shards = [idx[k * n_per_client:(k + 1) * n_per_client]
              for k in range(num_clients)]
    test_t = torch.as_tensor(test, dtype=torch.int64, device=dev)
    return FederatedSeqData(
        torch.as_tensor(train, dtype=torch.int64, device=dev), shards,
        test_t[:, :-1], test_t[:, 1:], vocab_size)


def build_lm_context(data: FederatedSeqData, sim: SimConfig,
                     model_cfg: ModelConfig, *,
                     device: DeviceLike = None) -> Context:
    """The LM context: the reference's ratio / budget protocol, priced by
    ``lm_memory`` at the task's sequence length, on ``device`` (the GPU
    unless ``"cpu"``; the data must already live there)."""
    dev = resolve_device(device)
    if data.device.type != dev.type:
        raise ValueError(f"data lives on {data.device}, context on {dev}")
    num_clients = len(data.client_indices)
    ratios = client_ratios(num_clients, sim.scenario, sim.seed)
    seq_len = int(data.x_test.shape[1])
    mem = lm_memory(model_cfg, sim.mem_batch, seq_len)
    budgets = scenario_budgets(mem, ratios)
    return Context(
        sim=sim, num_clients=num_clients, sizes=data.client_sizes(),
        rng=np.random.default_rng(sim.seed), seed=sim.seed, device=dev,
        model_cfg=model_cfg, mem=mem, ratios=ratios, budgets=budgets,
        decomps=[decompose(mem, int(b)) for b in budgets], data=data,
        prefix_stable=lm_prefix_stable(model_cfg))

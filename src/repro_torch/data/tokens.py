"""Synthetic token pipeline for the LM training / serving CLIs (the
port's own copy of ``repro.data.tokens``: numpy only, the same draws).

Deterministic per-shard generation (hash-seeded) so every data-parallel
host produces its own shard without coordination — the standard
"infinite synthetic corpus" pattern for infra bring-up.  The sequences
have learnable n-gram structure (mixture of Markov chains), so small-LM
training curves actually move.

It yields numpy arrays, bit for bit the reference's for every
``(seed, host_id)``; the train CLI (``repro_torch.launch.train``) moves
them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_size: int              # per-host batch
    seed: int = 0
    num_chains: int = 8          # mixture components
    order_skew: float = 1.5      # zipf-ish transition sharpness

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab_size, 4096)  # transition table over a head slice
        self._V = V
        # per-chain sparse-ish transition logits
        self._trans = rng.normal(size=(self.num_chains, V, 64)) * self.order_skew
        self._emit = rng.integers(0, V, size=(self.num_chains, V, 64))

    def _sample_batch(self, rng: np.random.Generator) -> np.ndarray:
        B, T, V = self.batch_size, self.seq_len, self._V
        chain = rng.integers(0, self.num_chains, size=B)
        toks = np.empty((B, T), np.int32)
        cur = rng.integers(0, V, size=B)
        toks[:, 0] = cur
        for t in range(1, T):
            logits = self._trans[chain, cur]                  # (B, 64)
            p = np.exp(logits - logits.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            choice = (p.cumsum(-1) > rng.random((B, 1))).argmax(-1)
            cur = self._emit[chain, cur, choice]
            toks[:, t] = cur
        return toks

    def batches(self, host_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Endless ``{"tokens", "labels"}`` batches of (B, T) int32, the
        labels the tokens shifted left with ``-100`` (ignored) last."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, host_id]))
        while True:
            toks = self._sample_batch(rng)
            labels = np.concatenate(
                [toks[:, 1:], np.full((toks.shape[0], 1), -100, np.int32)],
                axis=1)
            yield {"tokens": toks, "labels": labels}

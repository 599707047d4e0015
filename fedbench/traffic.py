"""The traffic of a cell, made on the device from ``--seed``.

A traffic file (``traffic/<name>.json``) sets the federation and its
load: the strategy and scenario, the number of clients and their
participation, how many batches of ``batch_size`` x ``seq_len`` tokens
each client trains a round, the local steps, the optimizer, the
scheduler and the wire.  This module reads any such file.

The data is the synthetic next-token task ``x_{t+1} = pi(x_t)`` with
probability ``1 - noise``, else a uniform token, over a permutation
``pi`` of the vocabulary.  Every (round, client) draws rows of its own,
so no two steps see the same rows; the seed changes the tokens and
nothing else of the work.
"""
from __future__ import annotations

import torch

MASK63 = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one use of the run's ``--seed`` (any whole
    number; the driver's exceed 32 bits)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) & MASK63


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def token_pool(traffic: dict, vocab: int, rounds: int, seed: int,
               device) -> torch.Tensor:
    """``(rounds, clients, batches, batch_size, seq_len + 1)`` int64
    token rows of the noisy-successor task, drawn in one pass."""
    shape = (rounds, traffic["num_clients"], traffic["batches_per_client"],
             traffic["batch_size"])
    n, T = 1, traffic["seq_len"] + 1
    for s in shape:
        n *= s
    gen = generator(seed, 2, device)
    pi = torch.randperm(vocab, generator=gen, device=device)
    noise = torch.rand(n, T, generator=gen, device=device) \
        < traffic["noise"]
    uniform = torch.randint(0, vocab, (n, T), generator=gen, device=device)
    rows = torch.empty(n, T, dtype=torch.int64, device=device)
    rows[:, 0] = uniform[:, 0]
    for t in range(1, T):
        rows[:, t] = torch.where(noise[:, t], uniform[:, t],
                                 pi[rows[:, t - 1]])
    return rows.reshape(*shape, T)


def batches(pool: torch.Tensor, rd: int, client: int) -> list:
    """The client's batches of round ``rd``, as the program takes them:
    ``[{"tokens": (B, T), "labels": (B, T)}, ...]``."""
    return [{"tokens": rows[:, :-1], "labels": rows[:, 1:]}
            for rows in pool[rd, client]]

"""FeDepth rounds in plain PyTorch (paper Algorithm 1), the reference
that decides ``correct``.

Each client of a round starts from the server's state and solves its
decomposition's subproblems in order.  Subproblem j trains units
[lo, hi) and the head (and the embedding where the model ties it, or
the block starts at 0) with SGD and momentum, the momentum reset per
subproblem; the frozen prefix's output is computed once per subproblem
and batch, before its steps, from the client's parameters at that
point.  The server then takes the clients' weighted mean (FedAvg,
weights in proportion to their data, here equal).

It reads nothing from the program: the weights and batches are the
benchmark's own, the blocks come from ``reference.memory``.  What it
records for the comparison: every step's loss, keyed by (round,
client, step), and the state after each round.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from fedbench import trees


def client_update(fam, cfg, flat: Dict[str, torch.Tensor], blocks,
                  batches, *, lr: float, momentum: float,
                  local_steps: int, losses: List[torch.Tensor]):
    """One client's depth-wise update from ``flat`` (never written);
    returns the client's new flat state and appends each step's loss to
    ``losses``."""
    flat = dict(flat)
    for lo, hi in blocks:
        with torch.no_grad():
            tree = trees.nest(flat)
            zs = [fam.apply_units(tree, cfg, fam.embed(tree, cfg, tok), 0, lo)
                  for tok, _ in batches]
        names = [p for p in flat if fam.trains(cfg, p, lo, hi)]
        train = {p: flat[p].detach().clone() for p in names}
        vel = {p: torch.zeros_like(t) for p, t in train.items()}
        for _ in range(local_steps):
            for z, (_, labels) in zip(zs, batches):
                for t in train.values():
                    t.requires_grad_(True)
                tree = trees.nest({**flat, **train})
                loss = fam.head_loss(tree, cfg,
                                     fam.apply_units(tree, cfg, z, lo, hi),
                                     labels)
                grads = torch.autograd.grad(loss, list(train.values()),
                                            allow_unused=True)
                losses.append(loss.detach())
                with torch.no_grad():
                    for (p, t), g in zip(train.items(), grads):
                        t.requires_grad_(False)
                        vel[p].mul_(momentum)
                        if g is not None:
                            vel[p].add_(g)
                        t.sub_(lr * vel[p])
        flat.update(train)
    return flat


def run_rounds(fam, cfg, traffic: dict, params, decomps,
               batches_of: Callable[[int, int], List[Tuple]],
               n_rounds: int, norm_rounds=()):
    """``n_rounds`` rounds from ``params`` over every client, in client
    order.  Returns (``{round: {path: norm of the change from params}}``
    for each round of ``norm_rounds``, ``{(round, client, step): loss}``
    as floats, ``{round: {path: the change}}`` on the host for the same
    rounds).  ``batches_of(round, client)`` gives the client's
    ``[(tokens, labels), ...]``; the clients weigh the same."""
    start = trees.flatten(params)
    flat = start
    C = traffic["num_clients"]
    w = torch.full((C,), 1.0 / C, dtype=torch.float32).tolist()
    norms, keyed, deltas = {}, {}, {}
    for rd in range(n_rounds):
        acc = None
        for k in range(C):
            losses: List[torch.Tensor] = []
            local = client_update(
                fam, cfg, flat, decomps[k].blocks, batches_of(rd, k),
                lr=traffic["lr"], momentum=traffic["momentum"],
                local_steps=traffic["local_steps"], losses=losses)
            for s, v in enumerate(losses):
                keyed[(rd, k, s)] = v
            with torch.no_grad():
                if acc is None:
                    acc = {p: t * w[k] for p, t in local.items()}
                else:
                    for p, t in local.items():
                        acc[p] += t * w[k]
            del local
        flat = acc
        if rd in norm_rounds:
            deltas[rd] = {}
            norms[rd] = trees.change_norms(flat, start, deltas[rd])
    vals = torch.stack(list(keyed.values())).tolist()
    return norms, dict(zip(keyed, vals)), deltas

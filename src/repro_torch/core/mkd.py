"""Mutual knowledge distillation (paper §Exploit Sufficient Memory; port
of ``repro.core.mkd``).

Clients with surplus memory (r >= 2) train M > 1 models jointly:

  min_{W^1..W^M}  (1/M) Σ_m F_k(W^m)
                  + (1/(M-1)) Σ_{m'≠m} KL(h^{m'} || h^m)

and upload ONE model (the knowledge consensus makes any of them
representative), keeping communication at 1x.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.blockwise import sgd_momentum_
from repro_torch.tree import tree_map


def kl_logits(p_logits: torch.Tensor,
              q_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(p) || softmax(q)), mean over batch."""
    pf = F.log_softmax(p_logits.float(), dim=-1)
    qf = F.log_softmax(q_logits.float(), dim=-1)
    return (pf.exp() * (pf - qf)).sum(-1).mean()


def mkd_loss(logits_fn: Callable, params_list: Sequence, batch,
             task_loss_fn: Callable) -> torch.Tensor:
    """Joint MKD objective over M models, at the reference's defaults:
    temperature 1, KD weight 1.

    ``logits_fn(params, batch) -> logits``; ``task_loss_fn(params, batch)
    -> scalar`` supervised loss.  Each model distills from its peers'
    current predictions, detached (deep mutual learning)."""
    M = len(params_list)
    if M < 2:
        raise ValueError("mutual distillation needs two models or more")
    logits = [logits_fn(p, batch) for p in params_list]
    task = sum(task_loss_fn(p, batch) for p in params_list) / M
    kd = 0.0
    for m in range(M):
        for mp in range(M):
            if mp != m:
                kd = kd + kl_logits(logits[mp].detach(), logits[m])
    return task + kd / (M * (M - 1))


def mkd_local_update(logits_fn, task_loss_fn, params_list: List, batches, *,
                     lr: float = 0.1, momentum: float = 0.9,
                     local_steps: int = 1):
    """SGD-momentum on the joint MKD objective; returns the updated list
    (new trees: the given ones are never written).  The caller uploads
    ``params_list[0]`` (paper: upload one model)."""
    plist = [tree_map(lambda t: t.detach().clone(), p) for p in params_list]
    vels = [tree_map(torch.zeros_like, p) for p in plist]

    for _ in range(local_steps):
        for batch in batches:
            sgd_momentum_(
                lambda: mkd_loss(logits_fn, plist, batch, task_loss_fn),
                plist, vels, lr=lr, momentum=momentum)
    return plist

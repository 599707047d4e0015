"""Optimizers + LR schedules (port of ``repro.train.optim``; no
``torch.optim``).

API: ``opt = sgd(...)``; ``state = opt.init(params)``; ``params, state =
opt.update(params, grads, state, step)``.  The reference is functional;
here ``update`` writes ``params`` and ``state`` in place (``torch._foreach``
over the leaves) and returns them.  A schedule takes an integer step and
returns a Python float.

Includes the paper's setup (SGD momentum + cosine) and MiniCPM's WSD
(warmup-stable-decay) schedule for the minicpm-2b assigned arch.  The
launch train step (``repro_torch.launch.steps``) inlines its own SGD, as
the reference's does: nothing on the launch path calls this module.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (params, grads, state, step) -> (params, state)
    slots: int                   # optimizer-state multiples of params (memory model)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------
def constant(lr: float) -> Callable[[int], float]:
    return lambda step: float(lr)


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.0) -> Callable[[int], float]:
    def sched(step: int) -> float:
        step = min(step, total_steps)
        warm = step / max(warmup, 1) if warmup > 0 else 1.0
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t))
        return lr * min(warm, 1.0) * cos
    return sched


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        stable_frac: float = 0.89, decay_frac: float = 0.10
        ) -> Callable[[int], float]:
    """MiniCPM warmup-stable-decay [arXiv:2404.06395]."""
    w = max(1, int(total_steps * warmup_frac))
    s = int(total_steps * stable_frac)
    d = max(1, total_steps - w - s)

    def sched(step: int) -> float:
        step = min(step, total_steps)
        if step < w:
            return lr * step / w
        if step < w + s:
            return float(lr)
        decay_t = min(max((step - w - s) / d, 0.0), 1.0)
        return lr * 0.5 * (1 + math.cos(math.pi * decay_t))
    return sched


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------
def _zeros(params):
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def _sgd_update(params, grads, vel, step, *, schedule, momentum,
                weight_decay):
    lr = schedule(step)
    p, g, v = tree_leaves(params), tree_leaves(grads), tree_leaves(vel)
    if weight_decay:
        g = torch._foreach_add(g, p, alpha=weight_decay)
    torch._foreach_mul_(v, momentum)
    torch._foreach_add_(v, g)
    torch._foreach_add_(p, v, alpha=-lr)
    return params, vel


def sgd(schedule: Callable, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def update(params, grads, vel, step):
        return _sgd_update(params, grads, vel, step, schedule=schedule,
                           momentum=momentum, weight_decay=weight_decay)

    return Optimizer(_zeros, update, slots=1)


@torch.no_grad()
def _adamw_update(params, grads, state, step, *, schedule, b1, b2, eps,
                  weight_decay):
    lr = schedule(step)
    t = step + 1
    p, g = tree_leaves(params), tree_leaves(grads)
    m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    # bias-corrected moments; the decay is decoupled, inside the step
    step_dir = torch._foreach_div(m, 1 - b1 ** t)
    denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step_dir, denom)
    torch._foreach_add_(step_dir, p, alpha=weight_decay)
    torch._foreach_add_(p, step_dir, alpha=-lr)
    return params, state


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(params, grads, state, step):
        return _adamw_update(params, grads, state, step, schedule=schedule,
                             b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay)

    return Optimizer(init, update, slots=2)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm): a new
    tree, as the reference returns; the norm (sqrt of the sum of every
    leaf's squares) a 0-d tensor on the leaves' device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        tree_leaves(grads))))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm

"""Depth-wise sequential learning (paper Eq. 1 + Figure 4), LM part.

Port of ``repro.core.blockwise``: for a client with decomposition
{(lo_1, hi_1), ...}, solve J subproblems in order.  Subproblem j trains
ONLY units [lo_j, hi_j) plus the head φ; the prefix is frozen and its
output activation z_{lo_j - 1} is buffered (:class:`PrefixCache`, default
on): computed once per distinct batch per subproblem under ``no_grad``,
reused across every SGD step, and advanced through the just-trained units
between subproblems.

Ownership (the reference is functional, this port updates in place): a
client's update never writes a tensor it was given.  Each subproblem
trains private clones of its split (the block's units, the head, and the
embedding when ``lo == 0``); ``merge`` returns a new tree that shares every
other tensor with its input.  So a cohort's payloads share their frozen
tensors with the server state, and the next client in the cohort starts
from the untouched broadcast.

ResNet / ViT / whisper runners, ``head="aux"`` (m-FeDepth) and the
stacked (vectorized) execution wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.core.decomposition import Decomposition
from repro_torch.models import common
from repro_torch.tree import tree_leaves, tree_map


# --------------------------------------------------------------------------
# family adapters
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockRunner:
    """Decomposes a model into (embed -> units -> head) for FeDepth."""
    n_units: int
    embed: Callable[[Any, Dict], torch.Tensor]            # params, batch -> z0
    apply_units: Callable[[Any, torch.Tensor, int, int], torch.Tensor]
    head_loss: Callable[[Any, torch.Tensor, Dict, int], torch.Tensor]
    # trainable subtree of units [lo, hi) + the head φ (+ embed at lo == 0)
    split: Callable[[Any, int, int], Any]
    merge: Callable[..., Any]
    # True when the params feeding ``embed`` and the prefix never change
    # while later subproblems train, so a buffered z_{lo-1} can be
    # advanced incrementally (False for tied embeddings: the head trains
    # the embedding table, so the prefix is re-buffered per subproblem)
    prefix_stable: bool = True


def lm_runner(lm, head: str = "skip") -> BlockRunner:
    """Runner over a dense-transformer ``LM`` (``repro_torch.models``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = lm.cfg
    if head != "skip":
        raise NotImplementedError("head='aux' (m-FeDepth) is not ported yet")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family!r} runner is not ported yet")
    head_keys = {"final_norm", "lm_head"}
    if cfg.tie_embeddings:
        head_keys |= {"embed"}

    def embed(params, batch):
        return transformer.embed_inputs(params, cfg, batch["tokens"])

    def apply_units(params, z, lo, hi):
        out, _aux = lm.apply_range(params, z, lo, hi)
        return out

    def head_loss(params, z, batch, block_idx):
        x = common.rms_norm(z, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        ce, _ = ops.cross_entropy(x, w, batch["labels"])
        return ce

    def split(params, lo, hi):
        train = {k: v for k, v in params.items() if k in head_keys}
        train["units"] = params["units"][lo:hi]
        if lo == 0 and "embed" not in train:
            train["embed"] = params["embed"]
        return train

    def merge(params, train, lo: int = None, hi: int = None):
        out = dict(params)
        for k, v in train.items():
            if k == "units":
                out[k] = params[k][:lo] + list(v) + params[k][hi:]
            else:
                out[k] = v
        return out

    return BlockRunner(lm.num_depth_units, embed, apply_units, head_loss,
                       split, merge, prefix_stable=not cfg.tie_embeddings)


# --------------------------------------------------------------------------
# the depth-wise sequential client update (paper Algorithm 1, ClientUpdate)
# --------------------------------------------------------------------------
def block_loss_fn(runner: BlockRunner, params_full, train_params, z_in,
                  batch, lo: int, hi: int, block_idx: int):
    """Loss of subproblem j: head(block(z_in)) with the prefix frozen.
    ``train_params`` are the differentiated leaves; everything else comes
    from ``params_full``, detached."""
    frozen = tree_map(torch.Tensor.detach, params_full)
    merged = runner.merge(frozen, train_params, lo=lo, hi=hi)
    z = runner.apply_units(merged, z_in.detach(), lo, hi)
    return runner.head_loss(merged, z, batch, hi - 1)


def _prox_term(train, anchor, prox_mu: float):
    sq = sum(((a - b) ** 2).sum() for a, b in zip(tree_leaves(train),
                                                  tree_leaves(anchor)))
    return 0.5 * prox_mu * sq


def _sgd_momentum_step(runner, params, train, vel, anchor, z_in, batch,
                       lo, hi, j, *, lr, momentum, prox_mu):
    """vel <- momentum * vel + grad; train <- train - lr * vel, in place on
    the client's private ``train`` / ``vel`` tensors.  A leaf the loss
    does not reach (the embedding of an untied LM, whose lookup feeds the
    frozen z_in) has zero gradient, as in the reference."""
    leaves = tree_leaves(train)
    for t in leaves:
        t.requires_grad_(True)
    loss = block_loss_fn(runner, params, train, z_in, batch, lo, hi, j)
    if prox_mu > 0:
        loss = loss + _prox_term(train, anchor, prox_mu)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        for t, v, g in zip(leaves, tree_leaves(vel), grads):
            v.mul_(momentum)
            if g is not None:
                v.add_(g)
            t.sub_(lr * v)
    for t in leaves:
        t.requires_grad_(False)
    return train, vel


def make_block_step(runner: BlockRunner, lo: int, hi: int, j: int, *,
                    lr: float, momentum: float, prox_mu: float = 0.0):
    """One SGD-momentum step on subproblem j, recompute variant: the
    frozen prefix forward runs inside every step (the reference path
    behind ``prefix_cache=False``)."""

    def step(params, train, vel, anchor, batch):
        with torch.no_grad():
            z_in = runner.embed(params, batch)
            if lo > 0:
                z_in = runner.apply_units(params, z_in, 0, lo)
        return _sgd_momentum_step(runner, params, train, vel, anchor, z_in,
                                  batch, lo, hi, j, lr=lr, momentum=momentum,
                                  prox_mu=prox_mu)

    return step


def make_buffered_block_step(runner: BlockRunner, lo: int, hi: int, j: int,
                             *, lr: float, momentum: float,
                             prox_mu: float = 0.0):
    """The :class:`PrefixCache` hot-path step: the same update rule, with
    the buffered prefix activation ``z_in`` as an argument — each step runs
    one block-local forward + backward, nothing else."""

    def step(params, train, vel, anchor, z_in, batch):
        return _sgd_momentum_step(runner, params, train, vel, anchor, z_in,
                                  batch, lo, hi, j, lr=lr, momentum=momentum,
                                  prox_mu=prox_mu)

    return step


def make_prefix_forward(runner: BlockRunner, lo: int):
    """From-scratch prefix forward z_{lo-1} = units[0, lo) over the embed
    output, without autograd (pure buffering)."""

    @torch.no_grad()
    def fwd(params, batch):
        z = runner.embed(params, batch)
        if lo > 0:
            z = runner.apply_units(params, z, 0, lo)
        return z

    return fwd


def make_prefix_advance(runner: BlockRunner, lo: int, hi: int):
    """Incremental advance: push a buffered z_{lo-1} through units
    [lo, hi) — the just-trained block — to obtain z_{hi-1}."""

    @torch.no_grad()
    def adv(params, z):
        return runner.apply_units(params, z, lo, hi)

    return adv


class PrefixCache:
    """Buffered z_{lo-1} activations for one client's depth-wise update.

    Per subproblem [lo, hi), :meth:`prepare` buffers the frozen-prefix
    output ONCE per distinct batch; every SGD step reuses its buffer.
    Between subproblems the buffers are advanced through the just-trained
    units when ``runner.prefix_stable``; otherwise they are re-buffered
    from scratch (still once per subproblem).  :meth:`buffered_bytes` is
    the quantity ``core.memory_model.ModelMemory.buffered_z_bytes``
    prices."""

    def __init__(self, runner: BlockRunner):
        self.runner = runner
        self.zs: Optional[list] = None   # one buffer per distinct batch
        self._lo: Optional[int] = None   # prefix depth of the buffers

    def reset(self) -> None:
        """Drop the buffers, so a reused instance never serves one
        client's activations to the next."""
        self.zs = None
        self._lo = None

    def prepare(self, params, batches, lo: int) -> list:
        """Buffer (or advance) z_{lo-1} for every batch; the advance only
        runs forward (lo above the buffered depth), anything else
        re-buffers."""
        if (self.zs is None or not self.runner.prefix_stable
                or lo < self._lo):
            fwd = make_prefix_forward(self.runner, lo)
            self.zs = [fwd(params, b) for b in batches]
        elif lo != self._lo:
            adv = make_prefix_advance(self.runner, self._lo, lo)
            self.zs = [adv(params, z) for z in self.zs]
        self._lo = lo
        return self.zs

    def buffered_bytes(self) -> int:
        if self.zs is None:
            return 0
        return sum(z.numel() * z.element_size() for z in self.zs)


def client_update(runner: BlockRunner, params, dec: Decomposition, batches,
                  *, lr: float = 0.1, momentum: float = 0.9,
                  local_steps: int = 1, prox_mu: float = 0.0,
                  prefix_cache: Union[bool, PrefixCache] = True):
    """Sequential depth-wise local update.  ``batches``: list of data
    batches cycled within each subproblem.  Returns the updated full
    params: a new tree sharing every untrained tensor with ``params``,
    which is never written.

    SGD with momentum per subproblem, momentum reset per block (each
    subproblem is its own optimization, paper Eq. 1).  ``prox_mu`` adds
    the FedProx term.  ``prefix_cache`` selects the execution contract:
    ``True`` buffers z_{lo-1} via :class:`PrefixCache`, ``False`` re-runs
    the prefix inside every step; pass a :class:`PrefixCache` to inspect
    the buffers afterwards."""
    cache: Optional[PrefixCache] = None
    if isinstance(prefix_cache, PrefixCache):
        cache = prefix_cache
        cache.reset()
    elif prefix_cache:
        cache = PrefixCache(runner)

    for j, (lo, hi) in enumerate(dec.blocks):
        zs = cache.prepare(params, batches, lo) if cache is not None \
            else None
        anchor = runner.split(params, lo, hi)
        train = tree_map(lambda t: t.detach().clone(), anchor)
        vel = tree_map(torch.zeros_like, train)
        if cache is not None:
            step = make_buffered_block_step(runner, lo, hi, j, lr=lr,
                                            momentum=momentum,
                                            prox_mu=prox_mu)
            for _ in range(local_steps):
                for z_in, batch in zip(zs, batches):
                    train, vel = step(params, train, vel, anchor, z_in,
                                      batch)
        else:
            step = make_block_step(runner, lo, hi, j, lr=lr,
                                   momentum=momentum, prox_mu=prox_mu)
            for _ in range(local_steps):
                for batch in batches:
                    train, vel = step(params, train, vel, anchor, batch)
        del vel, anchor
        params = runner.merge(params, train, lo=lo, hi=hi)
    return params


def full_model_loss(runner: BlockRunner, params, batch):
    """End-to-end loss through all units (eval)."""
    z = runner.embed(params, batch)
    z = runner.apply_units(params, z, 0, runner.n_units)
    return runner.head_loss(params, z, batch, runner.n_units - 1)

"""Step functions (train / prefill / decode) + the FeDepth block step
(port of ``repro.launch.steps``): what ``launch/train.py`` and
``launch/serve.py`` run.

Parameters are fp32 trees of tensors with fp32 SGD-momentum slots — the
paper's optimizer, priced as ``core.memory_model`` prices it.

**The train steps update in place.**  The reference's steps are
functional and XLA donates their buffers, so a new tree costs nothing;
in eager PyTorch a new tree would double the state (a full-depth yi-6b's
parameters, gradients and momentum are already 67.7 GiB).  So
:func:`make_train_step` and :func:`make_fedepth_block_step` write the
caller's ``params`` and momentum in place and return them — the
counterpart of donation.  Gradients accumulate into each leaf's
``.grad`` (``.backward()`` per microbatch, one buffer a leaf), the update
is ``torch._foreach_*`` over the leaves with the clip scale a 0-d device
tensor: no host sync and no tree-sized temporary inside a step.  The
returned loss and metrics are 0-d device tensors.

As in the reference, the train and block steps run each depth unit
rematerialized (the models' ``remat=True`` default,
``models.common.maybe_checkpoint``; ``common.disable_remat()`` turns it
off), and serving runs without; and the steps inline their SGD rather
than call ``train/optim.py``.  The reference's ``kernel_force`` is gone:
the tensors' device picks the route (``kernels/ops.py``).

**Sharded steps.**  Parameters laid out as DTensors by
``launch.sharding.distribute`` run through the same steps: the update
is the same ``torch._foreach_*`` calls on DTensors, and the clip norm
over sharded gradients is a DTensor reduction, so it reduces across
ranks.  ``grad_shardings`` (a placements tree, ``sharding.to_named``)
pins each gradient's layout before the update, as the reference pins its
fp32 accumulator; by default a gradient takes its parameter's.
``microbatch_shardings`` (the placements of one microbatch's dict)
reshards each microbatch after the split: a contiguous slice of a
batch-sharded batch lies on a few ranks only.  The reference stacks its
microbatches on a leading axis; the port's are a list, so the
placements are those of one microbatch, without that axis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape
from repro_torch.dtensor import is_dtensor
from repro_torch.launch.sharding import spec_leaves
from repro_torch.models.api import LM
from repro_torch.tree import tree_leaves, tree_map


def abstract_params(lm: LM, dtype=torch.bfloat16):
    """The model's parameter tree on the ``meta`` device in ``dtype``
    (the reference's bf16): shapes and dtypes, no allocation."""
    return lm.init(0, device="meta", dtype=dtype)


def abstract_opt_state(params_shape):
    """fp32 momentum slot per param, on the ``meta`` device."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                          device="meta"), params_shape)


def microbatches(batch: Dict, n: int, shardings: Optional[Dict] = None
                 ) -> List[Dict]:
    """``batch`` split into ``n`` contiguous microbatches along the batch
    axis: dim 1 for ``mrope_positions`` ((3, B, T)), dim 0 for every other
    tensor; a 0-d leaf (or a non-tensor) is kept whole in each.  With
    ``shardings`` ({key: placements}), each DTensor part is redistributed
    to its key's placements."""
    if n == 1:
        return [batch]

    def part(key, x, i):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        dim = 1 if key == "mrope_positions" else 0
        if x.shape[dim] % n:
            raise ValueError(f"{key}: batch of {x.shape[dim]} does not "
                             f"split into {n} microbatches")
        size = x.shape[dim] // n
        out = x.narrow(dim, i * size, size)
        if shardings is not None and is_dtensor(out):
            out = out.redistribute(out.device_mesh, shardings[key])
        return out

    return [{k: part(k, x, i) for k, x in batch.items()} for i in range(n)]


def _pin_grads(grads, leaves, grad_shardings) -> list:
    """Each DTensor gradient in the placements ``grad_shardings`` gives it
    (leaf order), or its parameter's."""
    pins = (spec_leaves(grad_shardings) if grad_shardings is not None
            else [t.placements if is_dtensor(t) else None for t in leaves])
    return [g if g is None or not is_dtensor(g)
            or tuple(g.placements) == tuple(pl)
            else g.redistribute(g.device_mesh, pl)
            for g, pl in zip(grads, pins)]


def _accumulate_grads(loss_fn, leaves, batch, accum_steps: int,
                      microbatch_shardings=None):
    """Run ``loss_fn(microbatch) -> (loss, metrics)`` over the
    microbatches, each ``.backward()`` of loss / ``accum_steps`` summing
    into the leaves' ``.grad`` (the reference's fp32 mean of the
    gradients).  Returns (the mean loss, the last microbatch's metrics,
    the gradients: ``None`` for a leaf the loss does not reach); every
    ``.grad`` is released."""
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    loss, metrics = None, {}
    try:
        for mb in microbatches(batch, accum_steps, microbatch_shardings):
            l, metrics = loss_fn(mb)
            (l / accum_steps).backward()
            part = l.detach() / accum_steps
            loss = part if loss is None else loss + part
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss, metrics, grads


@torch.no_grad()
def _momentum_update_(leaves, vel, grads, *, lr: float, momentum: float,
                      scale: Optional[torch.Tensor] = None) -> None:
    """v <- momentum * v + g * scale; p <- p - lr * v, in place.  ``g``
    (scaled in place: it is the step's own buffer) is zero for a leaf
    without gradient."""
    torch._foreach_mul_(vel, momentum)
    live = [i for i, g in enumerate(grads) if g is not None]
    gs = [grads[i] for i in live]
    if gs:
        if scale is not None:
            torch._foreach_mul_(gs, scale)
        torch._foreach_add_([vel[i] for i in live], gs)
    torch._foreach_add_(leaves, vel, alpha=-lr)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def make_train_step(lm: LM, *, lr: float = 1e-3, momentum: float = 0.9,
                    clip_norm: float = 1.0, accum_steps: int = 1,
                    grad_shardings=None, microbatch_shardings=None):
    """Full-model SGD-momentum train step (the paper-faithful baseline a
    memory-rich client runs; also the standard pretraining step):
    ``train_step(params, momentum_state, batch) -> (params,
    momentum_state, {"loss", "gnorm", **metrics})``, both trees updated
    in place.

    ``accum_steps > 1`` splits the batch into contiguous microbatches and
    sums their fp32 gradients / ``accum_steps`` into one buffer a leaf:
    live activation memory is one microbatch.  The update clips by the
    global norm: scale = min(1, clip_norm / max(gnorm, 1e-9)),
    v <- momentum * v + g * scale, p <- p - lr * v."""

    def train_step(params, momentum_state, batch):
        leaves, vel = tree_leaves(params), tree_leaves(momentum_state)
        loss, metrics, grads = _accumulate_grads(
            lambda mb: lm.loss_fn(params, mb), leaves, batch, accum_steps,
            microbatch_shardings)
        grads = _pin_grads(grads, leaves, grad_shardings)
        # the global norm over every gradient, fp32 on the device: per-leaf
        # norms (no squared copy of a leaf), then the norm of those
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [g for g in grads if g is not None])))
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        _momentum_update_(leaves, vel, grads, lr=lr, momentum=momentum,
                          scale=scale)
        return params, momentum_state, {"loss": loss, "gnorm": gnorm,
                                        **metrics}

    return train_step


def make_fedepth_block_step(lm: LM, lo: int, hi: int, *, lr: float = 1e-3,
                            momentum: float = 0.9, accum_steps: int = 1,
                            buffered_z: bool = False,
                            microbatch_shardings=None):
    """The paper's technique as a datacenter train step: differentiate only
    ``runner.split(params, lo, hi)`` (units [lo, hi) + head); the prefix
    runs without a gradient.  Optimizer state exists ONLY for the block,
    and there is no clipping (unlike the full step).

    ``accum_steps``: microbatch gradient accumulation (same motivation as
    the full step — one microbatch's activations live at a time).
    ``buffered_z``: the paper's z_{j-1} buffering — the batch carries the
    PRECOMPUTED prefix activation ``z_in`` (B,T,D) beside its labels, so
    the step skips the prefix forward entirely.

    Returns ``(block_step, runner)``; ``block_step(params, block_momentum,
    batch) -> (params, block_momentum, {"loss"})`` trains the split in
    place (its tensors are ``params``' own) and returns
    ``runner.merge(params, train)``."""
    from repro_torch.core import blockwise
    runner = blockwise.lm_runner(lm)

    def one_loss(params, train, batch):
        if buffered_z:
            z = batch["z_in"]
        else:
            with torch.no_grad():
                z = runner.embed(params, batch)
                if lo > 0:
                    z = runner.apply_units(params, z, 0, lo)
        return blockwise.block_loss_fn(runner, params, train, z, batch,
                                       lo, hi, hi - 1), {}

    def block_step(params, block_momentum, batch):
        train = runner.split(params, lo, hi)
        leaves = tree_leaves(train)
        loss, _, grads = _accumulate_grads(
            lambda mb: one_loss(params, train, mb), leaves, batch,
            accum_steps, microbatch_shardings)
        grads = _pin_grads(grads, leaves, None)
        _momentum_update_(leaves, tree_leaves(block_momentum), grads, lr=lr,
                          momentum=momentum)
        params = runner.merge(params, train, lo=lo, hi=hi)
        return params, block_momentum, {"loss": loss}

    return block_step, runner


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def make_prefill_step(lm: LM):
    def prefill_step(params, batch):
        return lm.prefill(params, batch)

    return prefill_step


def make_decode_step(lm: LM):
    def decode_step(params, batch):
        return lm.decode_step(params, batch["tokens"], batch["cache"],
                              batch["cache_index"],
                              mrope_positions=batch.get("mrope_positions"))

    return decode_step


def make_multi_decode_step(lm: LM, n_tokens: int):
    """Decode N tokens per call with greedy feedback (each step's argmax
    is the next step's token): returns (the N steps' logits stacked, (N,
    B, 1, V); the final cache).  ``decode_step`` writes the cache in
    place, so the returned cache is ``batch["cache"]`` advanced."""

    def multi_decode(params, batch):
        cache, idx, tok = batch["cache"], int(batch["cache_index"]), \
            batch["tokens"]
        out = []
        for i in range(n_tokens):
            logits, cache = lm.decode_step(params, tok, cache, idx + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(logits)
        return torch.stack(out), cache

    return multi_decode


def step_for_shape(lm: LM, shape: InputShape, *,
                   fedepth_block: Optional[Tuple[int, int]] = None,
                   accum_steps: int = 1, grad_shardings=None,
                   microbatch_shardings=None, buffered_z: bool = False,
                   decode_tokens: int = 1):
    """(step_fn, needs_opt_state) for the shape's mode."""
    if shape.mode == "train":
        if fedepth_block is not None:
            lo, hi = fedepth_block
            fn, _ = make_fedepth_block_step(
                lm, lo, hi, accum_steps=accum_steps, buffered_z=buffered_z,
                microbatch_shardings=microbatch_shardings)
            return fn, True
        return make_train_step(lm, accum_steps=accum_steps,
                               grad_shardings=grad_shardings,
                               microbatch_shardings=microbatch_shardings), True
    if shape.mode == "prefill":
        return make_prefill_step(lm), False
    if decode_tokens > 1:
        return make_multi_decode_step(lm, decode_tokens), False
    return make_decode_step(lm), False

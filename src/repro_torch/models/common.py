"""Shared building blocks of the transformer models (plain functions on
tensors; port of ``repro.models.common``).

Parameters are trees of tensors (``repro_torch.tree``).  Initialisation
draws from an explicit ``torch.Generator`` on the target device; it does
not reproduce ``jax.random`` — parity tests start both sides from the
reference's parameters (``repro_torch.testing.convert``).

The sharding hooks (the reference's ``common.py:71–148``) act on
DTensors (``torch.distributed.tensor``) inside :func:`mesh_context`: a
parameter tree laid out by ``launch.sharding.distribute`` runs the same
model code, each op propagated by DTensor, and :func:`shard_hint` pins a
layout the way ``with_sharding_constraint`` does.  On plain tensors, or
outside a mesh context, every hook is a no-op.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.dtensor import is_dtensor, replicate_like

DEFAULT_DTYPE = torch.float32
PARAM_SCALE = 0.02


# --------------------------------------------------------------------------
# mesh context and sharding hooks
# --------------------------------------------------------------------------
_MESH = None


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh, as the
    reference's ``with mesh:``."""
    global _MESH
    old = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = old


def _context_mesh():
    """The active mesh, or None outside :func:`mesh_context`."""
    return _MESH


@contextlib.contextmanager
def unroll_scans():
    """A no-op, kept for the reference's callers: XLA's cost analysis
    counts a loop body once, so the reference's dry run unrolls its depth
    scans; the port runs eagerly, and a counting mode sees every
    iteration."""
    yield


# --------------------------------------------------------------------------
# per-unit rematerialization
# --------------------------------------------------------------------------
# Perf knob: disable per-unit rematerialization (trades memory for ~25 %
# less backward compute: viable when the step's live set is far under the
# card's memory, e.g. FeDepth block steps).
_NO_REMAT = False


@contextlib.contextmanager
def disable_remat():
    """Run every :func:`maybe_checkpoint` body without rematerialization,
    whatever its ``remat`` argument; nests, and restores on exit."""
    global _NO_REMAT
    old = _NO_REMAT
    _NO_REMAT = True
    try:
        yield
    finally:
        _NO_REMAT = old


def maybe_checkpoint(body, remat: bool):
    """``body`` (a depth unit's forward: tensors and trees of tensors in,
    a tuple out) rematerialized when ``remat`` is on and no
    :func:`disable_remat` is active, else ``body`` itself (the reference's
    ``jax.checkpoint``).  Rematerialized, the body keeps only its inputs
    for the backward and runs its forward again there, K2–K4 launching
    again.  Eagerly that is ``torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)``, which composes with DTensor and the dry run's
    ``meta`` tensors (the recompute's ops dispatch again, so a counting
    mode sees them); under a functorch transform (the stacked path's
    ``vmap``), where that checkpoint cannot run, :class:`_Recompute`.
    Without grad mode (a frozen prefix, serving) the body runs as it is:
    nothing is saved to rematerialize."""
    if not remat or _NO_REMAT:
        return body

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return _remat(body, args)

    return run


def _remat(fn, args):
    """``fn(*args)`` rematerialized at the current functorch level:
    ``torch.utils.checkpoint`` eagerly; :class:`_Recompute` beneath a
    transform, or where a grad transform has disabled the saved-tensor
    hooks that checkpoint needs."""
    if (torch._C._functorch.maybe_current_level() is None
            and torch._C._autograd._saved_tensors_hooks_is_enabled()):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return _recompute(fn, args)


class _Recompute(torch.autograd.Function):
    """``call`` over flat tensors, rematerialized beneath a functorch
    transform.  Its vmap rule (the stacked path: the loss vmapped over
    the clients, then plain autograd) runs ``vmap(call)`` at the level
    below, rematerialized there (:func:`_remat`): eagerly by checkpoint,
    so the recompute runs the whole group's unit under plain autograd, as
    the sequential path's does (a recompute under ``torch.func.vjp``
    inside the vmapped backward held more at the peak: PERF.md §5).  Under a grad
    transform (``torch.func.grad`` / ``vjp``) it saves only its inputs
    and the backward runs the forward again under ``torch.func.vjp`` (the
    kernels' Functions have ``setup_context`` and vmap rules, so they run
    there)."""

    @staticmethod
    def forward(call, *flat):
        return call(*flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.saved_tensors
        need = [i for i, t in enumerate(flat)
                if ctx.needs_input_grad[i + 1]]

        def part(*xs):
            args = list(flat)
            for i, x in zip(need, xs):
                args[i] = x
            return ctx.call(*args)

        _, vjp = torch.func.vjp(part, *(flat[i] for i in need))
        out = [None] * len(flat)
        for i, g in zip(need, vjp(grads)):
            out[i] = g
        return (None, *out)

    @staticmethod
    def vmap(info, in_dims, call, *flat):
        out = _remat(torch.func.vmap(call, in_dims=in_dims[1:],
                                     randomness=info.randomness), flat)
        return out, (0,) * len(out)


def _recompute(body, args):
    """``body(*args)`` through :class:`_Recompute`: the tensors of
    ``args`` are its inputs, the rest of ``args`` and of the outputs (a
    Python float aux) held fixed."""
    from torch.utils._pytree import tree_flatten, tree_unflatten
    leaves, spec = tree_flatten(args)
    pos = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor)]
    out_spec, fixed = [], {}

    def call(*flat):
        full = list(leaves)
        for i, t in zip(pos, flat):
            full[i] = t
        outs, ospec = tree_flatten(body(*tree_unflatten(full, spec)))
        out_spec[:] = [ospec]
        fixed.clear()
        fixed.update({i: o for i, o in enumerate(outs)
                      if not isinstance(o, torch.Tensor)})
        return tuple(o for o in outs if isinstance(o, torch.Tensor))

    ts = iter(_Recompute.apply(call, *(leaves[i] for i in pos)))
    n = out_spec[0].num_leaves
    outs = [fixed[i] if i in fixed else next(ts) for i in range(n)]
    return tree_unflatten(outs, out_spec[0])


# Weight-stationary decode: at decode the batch is tiny and FSDP-sharded
# weights dominate; this mode pins decode activations replicated at the
# matmuls (gathering activations instead of weights), resharding to
# batch-on-data only around the KV-cache ops.
_WEIGHT_STATIONARY = False


@contextlib.contextmanager
def weight_stationary_decode():
    global _WEIGHT_STATIONARY
    old = _WEIGHT_STATIONARY
    _WEIGHT_STATIONARY = True
    try:
        yield
    finally:
        _WEIGHT_STATIONARY = old


def ws_replicate(x):
    """Pin x replicated (across every mesh axis) in WS-decode mode."""
    if not _WEIGHT_STATIONARY:
        return x
    return shard_hint(x, *([None] * x.dim()))


# Explicit expert-parallel all-to-all MoE — see moe_ep.py.
_EP_MOE = False


@contextlib.contextmanager
def ep_moe():
    global _EP_MOE
    old = _EP_MOE
    _EP_MOE = True
    try:
        yield
    finally:
        _EP_MOE = old


def ws_batch_sharded(x, bdim: int = 0):
    """Pin x's batch dim back onto 'data' in WS-decode mode."""
    if not _WEIGHT_STATIONARY:
        return x
    axes = [None] * x.dim()
    axes[bdim] = "data"
    return shard_hint(x, *axes)


def shard_hint(x, *axes):
    """Redistribute a DTensor ``x`` to the layout ``axes`` name (per dim
    a mesh axis, a tuple of axes, or None; an axis the mesh lacks, or that
    does not divide its dim, is dropped), the reference's
    ``with_sharding_constraint``.  A no-op on a plain tensor or outside
    :func:`mesh_context`."""
    mesh = _context_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, (dim, ax) in enumerate(zip(x.shape, axes)):
        split = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is None or a not in names:
                continue
            if dim % (split * mesh.size(names.index(a))) == 0:
                split *= mesh.size(names.index(a))
                out[names.index(a)] = Shard(d)
    if list(x.placements) == out:
        return x
    return x.redistribute(x.device_mesh, out)


def batch_hint(x):
    """Pin the residual stream (B, T, D), or a sublayer's output about to
    join it, to batch on the mesh's batch axes ("pod", "data"), whole on
    the rest: each layer then starts as tensor parallelism expects (its
    column-split weights give head-split q / k / v), and a row-split
    projection's pending sum over "model" is reduced where it is made
    (Megatron's all-reduce), rather than left in the layout DTensor's
    op-by-op choice leaves behind (the embedding lookup's split of D over
    "model"; a pending sum that a later product meets by gathering its
    weight and running whole on every rank)."""
    mesh = _context_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    batch = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return shard_hint(x, batch, *([None] * (x.dim() - 1)))


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, *, device,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], *, device,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return dense_init(gen, shape, PARAM_SCALE, device=device, dtype=dtype)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------
def head_weight(p: Dict[str, Any], cfg) -> torch.Tensor:
    """The (D, V) output head: ``embed.T`` when the config ties it."""
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with fp32 statistics."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a norm's or a softmax's statistics: fp32, or the
    input's own dtype when it is wider (float64 runs stay float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis with fp32 statistics (population
    variance), as the reference's ``common.layer_norm``."""
    dt = stat_dtype(x)
    out = F.layer_norm(x.to(dt), x.shape[-1:], weight.to(dt), bias.to(dt),
                       eps)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T).  Rotates the split halves
    (x1, x2) = x[..., :D/2], x[..., D/2:], not interleaved pairs."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (B, T, D/2)
    cos = replicate_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicate_like(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, T, H, D); positions: (3, B, T),
    the temporal / height / width position ids; ``sections`` splits the
    D/2 rotary frequencies among the three axes (they sum to D/2), and
    each frequency rotates by its axis's position."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {D // 2}")
    freqs = rope_freqs(D, theta, x.device)                  # (D/2,)
    # each slot's axis position, by slices and no index tensor (a DTensor
    # cannot be indexed by a plain one)
    pos = positions.float()
    angles = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], s)
                        for i, s in enumerate(sections)], dim=-1) \
        * replicate_like(freqs, pos)                        # (B, T, D/2)
    cos = replicate_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicate_like(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------
def causal_positions(batch: int, seq: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos.expand(batch, seq)

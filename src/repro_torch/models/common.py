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
    axis_of_slot = torch.cat([torch.full((s,), i, device=x.device)
                              for i, s in enumerate(sections)])
    pos_bt3 = positions.movedim(0, -1).float()              # (B, T, 3)
    angles = pos_bt3[..., axis_of_slot] * freqs             # (B, T, D/2)
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

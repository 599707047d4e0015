"""DTensor helpers shared by the models and the kernel ops (the sharded
layer: ``launch.sharding`` lays parameters out as DTensors on a
``torch.distributed`` ``DeviceMesh``, and the same model code runs on
them, each op propagated by DTensor)."""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` as a DTensor replicated over ``like``'s mesh when ``like`` is
    a DTensor (and ``t`` is not), else ``t`` as it is.  For an operand
    every rank computes the same from global shapes (RoPE's angles, an
    attention mask): DTensor refuses to mix a plain tensor with a
    DTensor, so the callers replicate it here, by name; no data moves."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole_where_uneven(t, dim: int, n: int):
    """A DTensor ``t`` about to have ``dim`` split into (n, rest): the
    mesh dims that shard ``dim`` and do not divide n are gathered first
    (DTensor cannot unflatten an uneven split, e.g. 4 kv heads over a
    "model" axis of 16); ``t`` as it is otherwise, or when plain."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    d = dim % t.dim()
    mesh = t.device_mesh
    pls = [Replicate() if isinstance(p, Shard) and p.dim == d
           and n % mesh.size(i) else p for i, p in enumerate(t.placements)]
    return t if pls == list(t.placements) else t.redistribute(mesh, pls)


class _GradAs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != list(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def grad_as_value(t):
    """``t`` (a DTensor), whose gradient is laid out as ``t`` itself is:
    an identity.  Before a flattened tensor's product, whose backward may
    split the flat dim where the unflatten back cannot follow (heads that
    do not divide the mesh axis)."""
    return _GradAs.apply(t, tuple(t.placements)) if is_dtensor(t) else t


def vocab_whole(table):
    """A DTensor (V, D) table with every mesh dim that splits its rows
    splitting its columns instead where D divides (an all-to-all), else
    gathered: a lookup then needs no masked partial."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    pls, cols = [], 1
    for i, p in enumerate(table.placements):
        if isinstance(p, Shard) and p.dim == 0:
            if table.shape[1] % (cols * mesh.size(i)) == 0:
                cols *= mesh.size(i)
                pls.append(Shard(1))
            else:
                pls.append(Replicate())
        else:
            if isinstance(p, Shard) and p.dim == 1:
                cols *= mesh.size(i)
            pls.append(p)
    if pls == list(table.placements):
        return table
    return table.redistribute(mesh, pls)

"""Mixture-of-Experts FFN layer with top-k routing (port of
``repro.models.moe``, its single-device dispatch).

Router: an fp32 softmax over the expert logits, the top k, their
probabilities renormalised over the chosen experts; the Switch
Transformer's load-balance loss from each token's first choice.

Dispatch is by capacity: each expert takes at most
``C = max(1, int(capacity_factor * N * K / E))`` of the N * K (token,
choice) pairs, in the flat (token, choice) order; a pair past its
expert's capacity is dropped (it adds a zero into slot 0, and its
combine weight is 0).  The expert FFNs run batched as (E, C, D) through
``torch.bmm`` — the reference's ``ecd,edf`` einsums, plain products
outside any kernel of its own.  Under ``common.ep_moe()`` inside a
mesh context whose "model" axis divides E, :func:`forward` delegates to
the expert-parallel path (``models/moe_ep.py``: explicit all-to-all
exchanges over that axis), as the reference's ``moe.py:70`` does.  On
DTensors the dispatch pins its expert buffers with ``common.shard_hint``
as the reference does (``moe.py:95–107``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dtensor import replicate_like
from repro_torch.models import common


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         dtype=common.DEFAULT_DTYPE) -> dict:
    """The router (D, E), the experts stacked as (E, D, F) / (E, F, D),
    and the shared experts' (D, F * S) SwiGLU when the config has any."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": common.dense_init(gen, (d, e), **kw),
        "w_gate": common.dense_init(gen, (e, d, f), 1 / math.sqrt(d), **kw),
        "w_up": common.dense_init(gen, (e, d, f), 1 / math.sqrt(d), **kw),
        "w_down": common.dense_init(gen, (e, f, d), 1 / math.sqrt(f), **kw),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_gate"] = common.dense_init(gen, (d, fs), **kw)
        p["shared_up"] = common.dense_init(gen, (d, fs), **kw)
        p["shared_down"] = common.dense_init(gen, (fs, d), **kw)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) without its range check, which reads
    the indices on the host and so cannot run under ``vmap`` (the stacked
    FeDepth path); the indices come from a sort over n experts.  On a
    DTensor the expert ids are replicated onto its mesh."""
    ids = replicate_like(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == ids).long()


def router_probs(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (N, E) -> (the fp32 router probabilities (N, E); the top-k
    probabilities (N, k), renormalised; their expert ids (N, k), in
    descending probability).

    Ties go to the lower expert id, as ``jax.lax.top_k`` breaks them: a
    stable descending sort keeps equal probabilities in id order."""
    probs = torch.softmax(logits.float(), dim=-1)               # (N, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_probs, topk_idx = order.values[:, :k], order.indices[:, :k]
    topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True).clamp_min(
        1e-9)
    return probs, topk_probs, topk_idx


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (N, E) -> (top-k probabilities (N, k), renormalised; their
    expert ids (N, k), in descending probability; the aux loss)
    (:func:`router_probs`)."""
    probs, topk_probs, topk_idx = router_probs(logits, k)
    # Switch-style load balance: E * sum_e(frac_tokens_e * mean_prob_e),
    # the first choice decides the load
    E = logits.shape[-1]
    frac = _one_hot(topk_idx[:, 0], E).float().mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    return topk_probs, topk_idx, aux


def forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (out (B, T, D), the router's aux loss, fp32)."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token

    if common._EP_MOE:
        mesh = common._context_mesh()
        if mesh is not None and "model" in mesh.mesh_dim_names \
                and E % mesh.size(mesh.mesh_dim_names.index("model")) == 0:
            from repro_torch.models import moe_ep
            return moe_ep.forward_ep(p, cfg, x, mesh,
                                     capacity_factor=capacity_factor)

    N = B * T
    xt = x.reshape(N, D)

    topk_probs, topk_idx, aux = router_topk(xt @ p["router"], K)
    C = max(1, int(capacity_factor * N * K / E))

    # each (token, choice)'s place in its expert's queue, in flat order
    flat_idx = topk_idx.reshape(-1)                             # (N*K,)
    onehot = _one_hot(flat_idx, E)                              # (N*K, E)
    pos = onehot.cumsum(0).gather(1, flat_idx[:, None])[:, 0] - 1
    keep = pos < C
    slot = torch.where(keep, flat_idx * C + pos, torch.zeros_like(pos))

    xr = xt.repeat_interleave(K, dim=0) * keep[:, None].to(x.dtype)
    xr = common.shard_hint(xr, "data", None)
    expert_in = replicate_like(torch.zeros(
        E * C, D, dtype=x.dtype, device=x.device), xr).index_add(
            0, slot, xr).reshape(E, C, D)
    # pin the expert-parallel layout: expert axis on "model"
    expert_in = common.shard_hint(expert_in, "model", None, None)
    h = F.silu(torch.bmm(expert_in, p["w_gate"])) \
        * torch.bmm(expert_in, p["w_up"])
    h = common.shard_hint(h, "model", None, None)
    expert_out = torch.bmm(h, p["w_down"])                      # (E, C, D)
    expert_out = common.shard_hint(expert_out, "model", None, None)

    # a dropped pair reads slot 0 with weight 0: no output, no gradient
    gathered = expert_out.reshape(E * C, D)[slot]               # (N*K, D)
    w = (topk_probs.reshape(-1) * keep).to(x.dtype)[:, None]
    out = (gathered * w).reshape(N, K, D).sum(1).reshape(B, T, D)

    if cfg.num_shared_experts:
        shared = common.swiglu(xt, p["shared_gate"], p["shared_up"],
                               p["shared_down"])
        out = out + shared.reshape(B, T, D)
    return out, aux.float()

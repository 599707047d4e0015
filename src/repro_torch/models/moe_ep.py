"""Expert-parallel MoE forward with explicit all-to-all exchanges (port of
``repro.models.moe_ep``): the manual-collective alternative to the
propagated dispatch of ``moe.forward``.

Per rank of the mesh:  route the local tokens to the rank owning their
expert (an all-to-all of (M, C, D) token buckets over the ``"model"``
group: activations, not weights) -> the local experts' FFN on the
resident weight shards -> all-to-all back -> weighted combine.

The steps mirror the reference's ``_local_moe`` (``moe_ep.py:35–95``):
capacity per (src, dst) pair ``C = max(1, int(cf * N_loc * K / M))``,
overflow pairs dropped as in ``moe.forward``; the buckets carry each
token's local expert as ``e_loc + 1`` (0 an empty slot).  The second-level
dispatch differs in form, not in value: the reference multiplies a dense
(M·C, E_loc) one-hot into (E_loc, M·C, D) expert inputs, every expert
over every received slot, which at qwen3-moe's widths on one rank (C =
65 536 at cf 8) is 137 GB; here each received slot goes into its expert's
queue (as long as the longest queue) and the experts run as one batched
product.  Requires E % M == 0; ``x`` is laid out batch-sharded on the
non-model axes and replicated on "model", as the reference's ``shard_map``
takes it, so each rank of a model group holds the same tokens.

Two faults of the reference are repaired here (ROADMAP §3):
  * fault 18: ``forward_ep`` drops the shared experts that ``moe.forward``
    adds; here they are added, so the output is ``moe.forward``'s;
  * fault 19: its aux loss is one shard's local estimate; here the
    expert counts and mean probabilities are summed over the data ranks
    first, so the aux is ``moe.forward``'s global one.

Gradients: the exchanges are ``torch.distributed.nn.functional``'s
``all_to_all_single`` (its backward is the reverse exchange).  Every rank
of a model group sends the same tokens, so each expert sees M copies of
a token and would take M times its gradient: the local expert weights
pass through a 1/M gradient scale.  The router's and the experts'
gradients are pending sums over the data ranks (each holds its tokens'
share).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dtensor import is_dtensor
from repro_torch.models import common
from repro_torch.models.moe import _one_hot, router_probs

# bytes each rank has put through the all-to-all exchanges (forward),
# reset by the caller
A2A = {"calls": 0, "bytes": 0}


class _GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(x, scale):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _exchange(t: torch.Tensor, group, differentiable: bool) -> torch.Tensor:
    """All-to-all of ``t`` (M equal row blocks) over ``group``."""
    import torch.distributed as dist
    A2A["calls"] += 1
    A2A["bytes"] += t.numel() * t.element_size()
    out = torch.empty_like(t)
    if differentiable:
        from torch.distributed.nn.functional import all_to_all_single
        return all_to_all_single(out, t.contiguous(), group=group)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _expert_queues(recv_x, recv_e, wg, wu, wd):
    """The second-level dispatch: each received slot (tag e + 1 for local
    expert e, 0 empty) through its expert's SwiGLU; an empty slot gives
    zeros.  Slots are queued per expert in arrival order, the queues
    padded to the longest, one batched product per weight."""
    E_loc, D = wg.shape[0], recv_x.shape[1]
    valid = recv_e > 0
    eidx = (recv_e - 1).clamp(min=0)
    oh = _one_hot(eidx, E_loc) * valid[:, None]                # (M*C, E_loc)
    qpos = oh.cumsum(0).gather(1, eidx[:, None])[:, 0] - 1
    # the longest queue; on ``meta`` (the dry run) no count can be read,
    # and a queue takes every slot, as the reference's dense dispatch
    # over (E_loc, M*C, D)
    cap = (recv_x.shape[0] if recv_x.device.type == "meta"
           else max(1, int(oh.sum(0).max())))
    # an empty slot goes to a spare row past the queues
    qidx = torch.where(valid, eidx * cap + qpos,
                       torch.full_like(eidx, E_loc * cap))
    expert_in = torch.zeros(E_loc * cap + 1, D, dtype=recv_x.dtype,
                            device=recv_x.device).index_add(0, qidx, recv_x)
    expert_in = expert_in[:-1].reshape(E_loc, cap, D)
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wu)
    expert_out = torch.bmm(h, wd).reshape(E_loc * cap, D)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, D)])
    return expert_out[qidx]                                    # (M*C, D)


def _local_moe(cfg: ModelConfig, M: int, capacity_factor: float, group):
    E, K = cfg.num_experts, cfg.experts_per_token
    E_loc = E // M

    def fn(x, router, wg, wu, wd):
        # x: (B_loc, T, D) local tokens; wg/wu/wd: (E_loc, D, F) local experts
        B, T, D = x.shape
        N = B * T
        xt = x.reshape(N, D)
        C = max(1, int(capacity_factor * N * K / M))   # slots per dst shard

        probs, topk_p, topk_i = router_probs(xt @ router, K)

        flat_e = topk_i.reshape(-1)                     # (N*K,) global expert
        dst = flat_e // E_loc                           # destination shard
        e_loc = flat_e % E_loc                          # expert on that shard
        onehot_dst = _one_hot(dst, M)
        pos = onehot_dst.cumsum(0).gather(1, dst[:, None])[:, 0] - 1
        keep = pos < C
        slot = torch.where(keep, dst * C + pos, torch.zeros_like(pos))

        keepf = keep[:, None].to(xt.dtype)
        xr = xt.repeat_interleave(K, dim=0) * keepf
        send_x = torch.zeros(M * C, D, dtype=xt.dtype,
                             device=xt.device).index_add(0, slot, xr)
        send_e = torch.zeros(M * C, dtype=torch.int64,
                             device=xt.device).index_add(
            0, slot, torch.where(keep, e_loc + 1, torch.zeros_like(e_loc)))

        # --- the explicit collective: token buckets to expert shards ----
        recv_x = _exchange(send_x, group, True)
        recv_e = _exchange(send_e, group, False)

        out_tokens = _expert_queues(recv_x, recv_e, wg, wu, wd)

        # --- route results back to the source shards --------------------
        back = _exchange(out_tokens, group, True)

        gathered = back[slot] * keepf                   # (N*K, D)
        w = topk_p.reshape(-1).to(xt.dtype)[:, None]
        out = (gathered * w).reshape(N, K, D).sum(1).reshape(B, T, D)
        # the load-balance aux's local sums: first-choice counts and
        # router probabilities over this rank's tokens
        counts = _one_hot(topk_i[:, 0], E).sum(0).float()
        return out, counts, probs.sum(0), N

    return fn


def _laid_out(t, mesh, pls):
    """``t`` as a DTensor on ``mesh`` with placements ``pls``: a plain
    tensor is the global value, the same on every rank (replicated, then
    laid out); a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t if list(t.placements) == list(pls) else t.redistribute(mesh, pls)


def forward_ep(p, cfg: ModelConfig, x, mesh, *,
               capacity_factor: float = 1.25
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``moe.forward`` on a ``DeviceMesh`` with a "model" axis
    dividing num_experts -> (out (B, T, D), the global aux loss, fp32),
    both DTensors on ``mesh``.  Parameters and ``x`` may be DTensors (any
    layout: each is laid out as the exchange needs it) or plain tensors
    holding the global value on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    names = mesh.mesh_dim_names
    mi = names.index("model")
    M = mesh.size(mi)
    assert cfg.num_experts % M == 0, (cfg.num_experts, M)
    E = cfg.num_experts
    data_dims = [i for i in range(mesh.ndim) if i != mi]
    n_shards = 1
    for i in data_dims:
        n_shards *= mesh.size(i)
    split = x.shape[0] % n_shards == 0
    x_pl = [Replicate() if i == mi or not split else Shard(0)
            for i in range(mesh.ndim)]
    rep = [Replicate()] * mesh.ndim
    exp_pl = [Shard(0) if i == mi else Replicate() for i in range(mesh.ndim)]
    # a rank's gradient of a weight is its tokens' share: a pending sum
    # over the ranks that split the tokens
    shares = [Partial() if i != mi and split else Replicate()
              for i in range(mesh.ndim)]
    exp_grad = [Shard(0) if i == mi else shares[i] for i in range(mesh.ndim)]

    x = _laid_out(x, mesh, x_pl)
    x_loc = x.to_local(grad_placements=x_pl)
    router = _laid_out(p["router"], mesh, rep).to_local(
        grad_placements=shares)
    experts = [_GradScale.apply(_laid_out(p[k], mesh, exp_pl).to_local(
        grad_placements=exp_grad), 1.0 / M)
        for k in ("w_gate", "w_up", "w_down")]

    fn = _local_moe(cfg, M, capacity_factor, mesh.get_group("model"))
    out_loc, counts, prob_sums, n_loc = fn(x_loc, router, *experts)
    out = DTensor.from_local(out_loc, mesh, x_pl, run_check=False)

    # fault 19: the aux from the global counts and mean probabilities
    tokens = n_loc * (n_shards if split else 1)
    sums = [Partial() if i != mi and split else Replicate()
            for i in range(mesh.ndim)]
    frac = DTensor.from_local(counts, mesh, sums,
                              run_check=False).redistribute(mesh, rep)
    mean_p = DTensor.from_local(prob_sums, mesh, sums,
                                run_check=False).redistribute(mesh, rep)
    aux = E * (frac / tokens * (mean_p / tokens)).sum()

    # fault 18: the shared experts, as moe.forward adds them
    if cfg.num_shared_experts:
        B, T, D = out.shape
        xt = x.reshape(B * T, D)
        shared = common.swiglu(xt, *(
            p[k] if is_dtensor(p[k]) else _laid_out(p[k], mesh, rep)
            for k in ("shared_gate", "shared_up", "shared_down")))
        out = out + shared.reshape(B, T, D)
    return out, aux.float()

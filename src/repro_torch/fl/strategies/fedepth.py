"""FeDepth / m-FeDepth (paper Algorithm 1) as an FLStrategy (port of
``repro.fl.strategies.fedepth``).

Composes: memory model -> per-client decomposition (precomputed in the
engine context) -> depth-wise sequential ClientUpdate -> plain FedAvg.
Variants:
  * ``head="skip"``  -> FeDepth   (skip-connection classifier)
  * ``head="aux"``   -> m-FeDepth (auxiliary classifiers on the ResNet;
    per-block rms-norm scales ``aux_norms`` into the shared head on LMs)
  * a ``ViTConfig``  -> paper Fig. 7's depth-wise ViT fine-tune
  * surplus clients (M > 1)       -> MKD local update (core.mkd)
  * clients below the finest block -> partial training (skip prefix)

The same class backs the registered strategies (the ResNet runner for the
image protocol, the LM runner when ``model_cfg`` is a ``ModelConfig``) and
``core.fedepth.FedepthServer``'s model-agnostic path: pass an explicit
``runner`` (any BlockRunner), optional ``mkd_fns=(logits_fn,
task_loss_fn)`` for surplus clients, ``masked_aggregation=True`` for the
beyond-paper per-leaf reweighting and ``prox_mu`` for FedProx.  The
batched hooks let the vectorized and sharded schedulers stack the
clients that share a decomposition, on every runner (the LM families'
kernels launch once a group); on an LM context FeDepth, the masked
variant and m-FeDepth group every client, since no LM client runs MKD.
The wire hooks delta-code the uplink against the broadcast state.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.vit_t16 import ViTConfig
from repro_torch.core import aggregation, blockwise, mkd
from repro_torch.core.blockwise import BlockRunner
from repro_torch.fl.baselines import _ce
from repro_torch.fl.comm.payload import WireSpec
from repro_torch.fl.registry import register
from repro_torch.fl.strategies import common
from repro_torch.fl.strategy import ClientResult, wire_bytes
from repro_torch.models import build, image_model, resnet, vit
from repro_torch.tree import tree_map


@register("fedepth")
class FedepthStrategy:
    def __init__(self, head: str = "skip", *,
                 runner: Optional[BlockRunner] = None,
                 mkd_fns: Optional[Tuple[Callable, Callable]] = None,
                 masked_aggregation: bool = False, prox_mu: float = 0.0):
        self.head = head
        self.runner = runner
        self.mkd_fns = mkd_fns
        self.masked_aggregation = masked_aggregation
        self.prox_mu = prox_mu

    def setup(self, ctx):
        if self.runner is None:
            if isinstance(ctx.model_cfg, ModelConfig):
                self.runner = blockwise.lm_runner(build(ctx.model_cfg),
                                                  head=self.head)
            elif isinstance(ctx.model_cfg, ViTConfig):
                self.runner = blockwise.vit_runner(ctx.model_cfg)
            else:
                self.runner = blockwise.resnet_runner(ctx.model_cfg,
                                                      head=self.head)

    def init_state(self, ctx):
        if isinstance(ctx.model_cfg, ModelConfig):
            lm = build(ctx.model_cfg)
            params = lm.init(ctx.seed, device=ctx.device)
            if self.head == "aux":
                # m-FeDepth on LMs: one rms-norm scale per depth unit,
                # feeding the shared head (blockwise.lm_runner's
                # head_loss reads aux_norms[block_idx])
                params["aux_norms"] = torch.ones(
                    lm.num_depth_units, ctx.model_cfg.d_model,
                    dtype=torch.float32, device=ctx.device)
            return params
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        if isinstance(ctx.model_cfg, ViTConfig):
            return vit.init(gen, ctx.model_cfg, device=ctx.device)
        params = resnet.init(gen, ctx.model_cfg, device=ctx.device)
        if self.head == "aux":
            params["aux_heads"] = init_aux_heads(ctx.model_cfg, gen,
                                                 device=ctx.device)
        return params

    def _mkd_available(self, ctx) -> bool:
        """A surplus client needs an MKD implementation to exploit M > 1:
        explicit ``mkd_fns`` (generic runner) or the ResNet path.  LM
        configs have neither, so they take the plain depth-wise update."""
        return (self.mkd_fns is not None
                or (ctx.model_cfg is not None
                    and not isinstance(ctx.model_cfg, ModelConfig)))

    def client_update(self, ctx, state, client_id, batches):
        M = 1 if ctx.surplus is None else int(ctx.surplus[client_id])
        if M > 1 and self._mkd_available(ctx):
            local = self._mkd_update(ctx, state, batches, M)
        else:
            local = blockwise.client_update(
                self.runner, state, ctx.decomps[client_id], batches,
                lr=ctx.sim.lr, momentum=ctx.sim.momentum,
                local_steps=ctx.sim.local_steps, prox_mu=self.prox_mu,
                prefix_cache=ctx.prefix_cache)
        result = ClientResult(local, float(ctx.sizes[client_id]))
        if self.masked_aggregation:
            mask = aggregation.trained_mask_for(
                state, ctx.decomps[client_id], self.runner)
            # only the trained model crosses the wire; the mask is
            # derivable server-side from the client's decomposition
            result.payload = (local, mask)
            result.comm_bytes = wire_bytes(local)
        return result

    # ---------------------------------------------- batched capability
    def client_group_key(self, ctx, client_id):
        """Clients sharing a decomposition run the same depth-wise
        computation and stack; MKD surplus clients (M > 1 with an MKD
        implementation: never on an LM context) keep the sequential
        path."""
        M = 1 if ctx.surplus is None else int(ctx.surplus[client_id])
        if M > 1 and self._mkd_available(ctx):
            return None
        dec = ctx.decomps[client_id]
        return (dec.blocks, dec.skipped_prefix)

    def client_update_batched(self, ctx, state, client_ids,
                              batches_per_client):
        """One stacked update for the whole group (partial-training prefix
        skips and m-FeDepth's aux heads or ``aux_norms`` ride along: both
        live in the shared decomposition and the parameter tree), on any
        runner (:func:`blockwise.make_group_update`)."""
        update = self.group_update_fn(ctx, client_ids)
        group = len(batches_per_client)
        locals_ = blockwise.unstack_tree(
            update(blockwise.broadcast_tree(state, group),
                   blockwise.stack_batches(batches_per_client)), group)
        return self.group_results(ctx, state, client_ids, locals_)

    def group_update_fn(self, ctx, client_ids):
        """The group update for this group's shared decomposition, the
        function ``client_update_batched`` runs."""
        return blockwise.group_update_for(
            self.runner, ctx.decomps[client_ids[0]], lr=ctx.sim.lr,
            momentum=ctx.sim.momentum, local_steps=ctx.sim.local_steps,
            prox_mu=self.prox_mu, prefix_cache=ctx.prefix_cache)

    def group_results(self, ctx, state, client_ids, locals_):
        """A group's results: weight ~ |D_k|; under masked aggregation the
        group's shared trained-mask rides in the payload and the wire is
        priced as the trained model alone."""
        mask = self.group_mask(ctx, state, client_ids[0])
        results = []
        for cid, local in zip(client_ids, locals_):
            res = ClientResult(local, float(ctx.sizes[cid]))
            if self.masked_aggregation:
                res.payload = (local, mask)
                res.comm_bytes = wire_bytes(local)
            results.append(res)
        return results

    def group_mask(self, ctx, state, client_id):
        """The trained-mask of the client's decomposition under masked
        aggregation (cached per decomposition in ``ctx.caches``), ``None``
        when aggregating unmasked."""
        if not self.masked_aggregation:
            return None
        dec = ctx.decomps[client_id]
        cache = ctx.caches.setdefault("fedepth_group_masks", {})
        key = (dec.blocks, dec.skipped_prefix)
        if key not in cache:
            cache[key] = aggregation.trained_mask_for(state, dec,
                                                      self.runner)
        return cache[key]

    # ------------------------------------------------- wire contract
    def wire_parts(self, ctx, state, result):
        """Lossy uplink codecs encode the client's delta against the
        broadcast state: a partial-training client's untouched prefix and
        an MKD client's carried leaves delta to exact zeros, which
        sparsifying codecs skip.  Under masked aggregation the
        trained-mask rides along unencoded (the server can derive it from
        the client's decomposition)."""
        if self.masked_aggregation:
            local, tm = result.payload
            return WireSpec(local, ref=state,
                            rebuild=lambda t, _tm=tm: (t, _tm))
        return WireSpec(result.payload, ref=state)

    def downlink_tree(self, ctx, state, client_id):
        """Depth-wise downlink slice.  Subproblem j needs only ``embed +
        units[0, hi_j) + head``, so a round's staged downloads telescope
        to ``embed + units[0, hi_last) + head`` — and FeDepth
        decompositions always cover the last unit, so the slice is the
        full model; FeDepth's downlink savings come from the "delta"
        mode."""
        return state

    def aggregate(self, ctx, state, results):
        ws = [r.weight for r in results]
        if self.masked_aggregation:
            return aggregation.aggregate_masked(
                state, [r.payload[0] for r in results], ws,
                [r.payload[1] for r in results])
        return aggregation.fedavg([r.payload for r in results], ws)

    def aggregate_async(self, ctx, state, results, stalenesses, *,
                        alpha=0.5):
        """PER-BLOCK staleness merge: a FeDepth payload is a full model,
        but only the leaves inside the client's trained blocks carry
        fresh gradient information — the rest is the stale broadcast copy
        riding along.  Discount the two differently via soft masks:
        trained leaves by ``s(tau_k)``, carried leaves by ``s(2 tau_k)``
        (under ``masked_aggregation`` carried leaves are excluded
        outright, matching the sync path).  The lost weight mass anchors
        on the current global params.  All-zero staleness reduces every
        factor to 1 (or the binary mask) and the anchor to 0 — i.e.
        ``aggregate``, to float tolerance.

        The trained-mask depends on the decomposition only, so one mask
        the size of the model is cached per distinct decomposition in
        ``ctx.caches["fedepth_async_masks"]``.  Falls back to the
        weight-discount default when results carry no ``client_id`` /
        the context has no decompositions."""
        from repro_torch.fl.systime.staleness import (
            default_aggregate_async, polynomial_discount)
        if ctx.decomps is None or any(r.client_id is None for r in results):
            return default_aggregate_async(self, ctx, state, results,
                                           stalenesses, alpha=alpha)
        mask_cache = ctx.caches.setdefault("fedepth_async_masks", {})
        locals_, masks, weights = [], [], []
        anchor = 0.0
        for r, tau in zip(results, stalenesses):
            s = polynomial_discount(tau, alpha)
            if self.masked_aggregation:
                local, tm = r.payload
                soft = tree_map(lambda m, _s=s: m * _s, tm)
            else:
                local = r.payload
                dec = ctx.decomps[r.client_id]
                key = (dec.blocks, dec.skipped_prefix)
                if key not in mask_cache:   # mask depends only on dec
                    mask_cache[key] = aggregation.trained_mask_for(
                        state, dec, self.runner)
                tm = mask_cache[key]
                s2 = polynomial_discount(2 * tau, alpha)
                soft = tree_map(
                    lambda m, _s=s, _s2=s2: m * _s + (1.0 - m) * _s2, tm)
            locals_.append(local)
            masks.append(soft)
            weights.append(r.weight)
            anchor += r.weight * (1.0 - s)
        if anchor > 0.0:
            locals_.append(state)
            masks.append(tree_map(torch.ones_like, state))
            weights.append(anchor)
        return aggregation.aggregate_masked(state, locals_, weights, masks)

    def eval_model(self, ctx, state, x, y):
        if isinstance(ctx.model_cfg, ModelConfig):
            return common.lm_accuracy(ctx.model_cfg, state, x, y)
        return common.image_accuracy(ctx.model_cfg, state, x, y)

    # ---------------------------------------------------------- MKD local
    def _mkd_update(self, ctx, state, batches, M: int):
        """Surplus clients train M models with mutual KD and upload one."""
        kw = dict(lr=ctx.sim.lr, momentum=ctx.sim.momentum,
                  local_steps=ctx.sim.local_steps)
        if self.mkd_fns is not None:       # model-agnostic (server) path
            logits_fn, task_fn = self.mkd_fns
            return mkd.mkd_local_update(logits_fn, task_fn, [state] * M,
                                        batches, **kw)[0]
        # image path (aux heads ride along untouched)
        cfg = ctx.model_cfg
        apply = image_model(cfg).apply

        def logits_fn(p, b):
            return apply(p, cfg, b["images"])

        def task_fn(p, b):
            return _ce(logits_fn(p, b), b["labels"])

        model = {k: v for k, v in state.items() if k != "aux_heads"}
        trained = mkd.mkd_local_update(logits_fn, task_fn, [model] * M,
                                       batches, **kw)[0]
        return {**state, **trained}


register("m-fedepth")(functools.partial(FedepthStrategy, head="aux"))


def init_aux_heads(cfg, gen: torch.Generator, *, device):
    """m-FeDepth: one tiny linear classifier per block exit, drawn from
    ``gen``."""
    aux = {}
    for i, (_cin, cout, _) in enumerate(resnet.block_channels(cfg)):
        w = torch.randn(cout, cfg.num_classes, generator=gen, device=device)
        aux[f"b{i}"] = {"w": w / cout ** 0.5,
                        "b": torch.zeros(cfg.num_classes, device=device)}
    return aux


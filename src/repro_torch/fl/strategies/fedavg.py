"""FedAvg at the cohort's lowest common width (x min r) — the
lowest-common-denominator baseline (McMahan et al. 2017; port of
``repro.fl.strategies.fedavg``): every client trains the SAME slimmed
model, so no heterogeneity machinery at all.  That homogeneity makes it
trivially batchable: the whole cohort is one vectorization group.  On a
ViT config it is paper Fig. 7's x1/6 baseline.  Under system time every
client is priced as that subnet (``client_work``) and a stale result's
lost weight anchors on the server (``aggregate_async``).  The shardable
hooks wait for their slice.
"""
from __future__ import annotations

from repro_torch.core import aggregation
from repro_torch.fl import width as width_util
from repro_torch.fl.baselines import (fedavg_group_update, fedavg_local,
                                      fedavg_local_batched)
from repro_torch.fl.registry import register
from repro_torch.fl.strategies import common
from repro_torch.fl.strategy import ClientResult
from repro_torch.models import image_model


@register("fedavg")
class FedAvgStrategy:
    def setup(self, ctx):
        from repro_torch.fl.engine import SCENARIOS
        self.r_min = min(min(SCENARIOS[ctx.sim.scenario]), 1.0)
        self.sub_cfg = width_util.subnet_config(ctx.model_cfg, self.r_min)

    def client_work(self, ctx, client_id):
        """System-time pricing: EVERY client trains the x min r subnet,
        not its own budget's decomposition."""
        return self.r_min

    # Wire contract: no hooks needed.  The x min r subnet is the
    # wire-minimal model, so the channel's defaults are exact: the sliced
    # downlink is the whole state, and the payload is congruent with the
    # state, so ``default_wire_parts`` delta-codes the uplink.

    def init_state(self, ctx):
        return image_model(self.sub_cfg).init(ctx.seed, self.sub_cfg,
                                              device=ctx.device)

    def client_update(self, ctx, state, client_id, batches):
        local = fedavg_local(self.sub_cfg, state, batches, lr=ctx.sim.lr,
                             momentum=ctx.sim.momentum,
                             local_steps=ctx.sim.local_steps)
        return ClientResult(local, float(ctx.sizes[client_id]))

    # ---------------------------------------------- batched capability
    def client_group_key(self, ctx, client_id):
        return "fedavg"        # every client runs the identical subnet

    def client_update_batched(self, ctx, state, client_ids,
                              batches_per_client):
        locals_ = fedavg_local_batched(
            self.sub_cfg, state, batches_per_client, lr=ctx.sim.lr,
            momentum=ctx.sim.momentum, local_steps=ctx.sim.local_steps)
        return self.group_results(ctx, state, client_ids, locals_)

    def group_update_fn(self, ctx, client_ids):
        """The full-model group SGD that ``fedavg_local_batched`` runs,
        for executors that dispatch it themselves (the sharded
        scheduler)."""
        return fedavg_group_update(self.sub_cfg, ctx.sim.lr,
                                   ctx.sim.momentum, ctx.sim.local_steps)

    def group_results(self, ctx, state, client_ids, locals_):
        return [ClientResult(local, float(ctx.sizes[cid]))
                for cid, local in zip(client_ids, locals_)]

    def group_mask(self, ctx, state, client_id):
        return None        # plain FedAvg aggregation, no per-leaf masks

    def aggregate(self, ctx, state, results):
        return aggregation.fedavg([r.payload for r in results],
                                  [r.weight for r in results])

    def aggregate_async(self, ctx, state, results, stalenesses, *,
                        alpha=0.5):
        """Anchored staleness discount: the weight mass a stale result
        loses, ``w_k * (1 - s(tau_k))``, goes to the CURRENT global
        params instead of renormalizing over the cohort — stale mass
        reverts to the server, fresh mass moves it.  All-zero staleness
        makes the anchor weight 0 and this IS ``aggregate``."""
        from repro_torch.fl.systime.staleness import polynomial_discount
        disc = [polynomial_discount(t, alpha) for t in stalenesses]
        payloads = [r.payload for r in results]
        weights = [r.weight * s for r, s in zip(results, disc)]
        anchor = sum(r.weight * (1.0 - s) for r, s in zip(results, disc))
        if anchor > 0.0:
            payloads.append(state)
            weights.append(anchor)
        return aggregation.fedavg(payloads, weights)

    def eval_model(self, ctx, state, x, y):
        return common.image_accuracy(self.sub_cfg, state, x, y)

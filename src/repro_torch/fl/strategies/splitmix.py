"""SplitMix (Hong et al. 2022) as an FLStrategy (port of
``repro.fl.strategies.splitmix``): K = round(1/r) independent base
networks of width r; clients train rotating subsets sized to their
budget; the global model is the logit-mean ensemble.

A client's base-net subset is drawn from the shared stream AFTER its
batches (the scheduler draws the batches first), in the reference's
order.  On the wire each trained base net is delta-coded against the
server's copy, tagged with the base ids.  Under system time a client is
priced at a width-equivalent ratio of its base nets (``client_work``).
"""
from __future__ import annotations

from repro_torch.fl.baselines import SplitMixState, fedavg_local
from repro_torch.fl.comm.payload import WireSpec
from repro_torch.fl.registry import register
from repro_torch.fl.strategy import ClientResult, accuracy
from repro_torch.tree import tree_map


@register("splitmix")
class SplitMixStrategy:
    def init_state(self, ctx):
        from repro_torch.fl.engine import SCENARIOS
        base_r = min(min(SCENARIOS[ctx.sim.scenario]), 1.0)
        return SplitMixState(ctx.model_cfg, base_r, ctx.seed,
                             device=ctx.device)

    def client_work(self, ctx, client_id):
        """System-time pricing, first order: cap ~ r / base_r base nets of
        width base_r cost ~ cap * base_r^2 = r * base_r in FLOPs, i.e. a
        width-equivalent ratio of sqrt(r * base_r)."""
        from repro_torch.fl.engine import SCENARIOS
        base_r = min(min(SCENARIOS[ctx.sim.scenario]), 1.0)
        r = float(min(ctx.ratios[client_id], 1.0))
        return (r * base_r) ** 0.5

    def client_update(self, ctx, state, client_id, batches):
        cap = state.capacity(min(ctx.ratios[client_id], 1.0))
        chosen = ctx.rng.choice(state.k, size=cap, replace=False)
        trained = []
        for b_idx in chosen:
            new = fedavg_local(state.base_cfg, state.bases[b_idx], batches,
                               lr=ctx.sim.lr, momentum=ctx.sim.momentum,
                               local_steps=ctx.sim.local_steps)
            trained.append((int(b_idx), new))
        return ClientResult(trained, float(ctx.sizes[client_id]))

    def wire_parts(self, ctx, state, result):
        """Each trained base net is delta-coded against the server's copy;
        the base ids ride along uncompressed.  Two rounds' wires can share
        their structure (same capacity) yet cover different base nets, so
        the wire is tagged with the base ids: error feedback re-applies a
        residual only under a matching tag."""
        idxs = tuple(int(i) for i, _ in result.payload)
        trees = [t for _, t in result.payload]
        ref = [state.bases[i] for i in idxs]
        return WireSpec(trees, ref=ref, tag=idxs,
                        rebuild=lambda ts, _ix=idxs:
                        [(i, t) for i, t in zip(_ix, ts)])

    def downlink_tree(self, ctx, state, client_id):
        """A capacity-``cap`` client downloads ``cap`` base nets.  Which
        ones is drawn later, in ``client_update``; every base has one
        architecture, so the first ``cap`` price it exactly.  A
        ``SplitMixState`` is no tree of tensors, so the engine's full
        downlink is priced through this hook."""
        cap = state.capacity(min(float(ctx.ratios[client_id]), 1.0))
        return state.bases[:cap]

    def aggregate(self, ctx, state, results):
        """Per-base uniform averaging over the clients that trained it
        (SplitMix weights every update equally); the state is updated in
        place and returned."""
        updates = [[] for _ in range(state.k)]
        for r in results:
            for b_idx, new in r.payload:
                updates[b_idx].append(new)
        for b_idx, ups in enumerate(updates):
            if ups:
                state.bases[b_idx] = tree_map(
                    lambda *xs: sum(xs[1:], xs[0].clone()) / len(xs), *ups)
        return state

    def eval_model(self, ctx, state, x, y):
        return accuracy(state.ensemble_logits, x, y)

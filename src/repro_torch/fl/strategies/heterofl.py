"""HeteroFL (Diao et al. 2021) as an FLStrategy (port of
``repro.fl.strategies.heterofl``): width slimming with nested
prefix-slice aggregation.  Each client trains the first round(r*C)
channels; the server averages each coordinate over the clients whose
slice covers it.

Clients sharing a width ratio train the identical subnet, so they batch
as one vectorization group (slice once, vmap the local SGD, pad each).
On the wire only the width slice crosses (``wire_parts``' mask, and the
sliced downlink's ``downlink_tree``).  Under system time a client is
priced as its width slice (``client_work``), and a stale result's lost
weight joins the per-coordinate average as a full-coverage anchor on the
server (``aggregate_async``).
"""
from __future__ import annotations

import torch

from repro_torch.fl import width as width_util
from repro_torch.fl.comm.payload import WireSpec
from repro_torch.fl.baselines import (fedavg_local_batched,
                                      heterofl_aggregate, heterofl_local)
from repro_torch.fl.registry import register
from repro_torch.fl.strategies import common
from repro_torch.fl.strategy import ClientResult, wire_bytes
from repro_torch.models import resnet
from repro_torch.tree import tree_leaves, tree_map


def _slice_coords(mask) -> int:
    # the wire carries the r-width slice, not the zero-padded tree: the
    # mask's nonzero count IS the slice's coordinate count
    return sum(int(torch.count_nonzero(m)) for m in tree_leaves(mask))


@register("heterofl")
class HeteroFLStrategy:
    def init_state(self, ctx):
        return resnet.init(ctx.seed, ctx.model_cfg, device=ctx.device)

    def client_work(self, ctx, client_id):
        """System-time pricing: a width slice, never the FeDepth
        blocks."""
        return float(min(ctx.ratios[client_id], 1.0))

    @staticmethod
    def _wire_for(ctx, ratio: float, mask) -> int:
        # the upload size is fixed per (experiment, ratio): cached in the
        # experiment's context, never on the reusable strategy
        cache = ctx.caches.setdefault("heterofl_wire", {})
        if ratio not in cache:
            cache[ratio] = wire_bytes(n_coords=_slice_coords(mask))
        return cache[ratio]

    # ------------------------------------------------- wire contract
    def wire_parts(self, ctx, state, result):
        """Only the width slice crosses the wire: the mask restricts the
        codec to the slice's coordinates (the zero padding is never
        encoded or counted), and the delta reference is the masked
        broadcast state, so lossy codecs see true in-slice deltas."""
        padded, mask = result.payload
        ref = tree_map(lambda s, m: s * m, state, mask)
        return WireSpec(padded, ref=ref, mask=mask,
                        rebuild=lambda t, _m=mask: (t, _m))

    def downlink_tree(self, ctx, state, client_id):
        """Sliced downlink: a width-r client downloads exactly its
        first-round(r * C)-channels subnet."""
        r = float(min(ctx.ratios[client_id], 1.0))
        return width_util.slice_resnet(state, ctx.model_cfg, r)[0]

    def client_update(self, ctx, state, client_id, batches):
        r = min(ctx.ratios[client_id], 1.0)
        padded, mask = heterofl_local(
            ctx.model_cfg, state, r, batches, lr=ctx.sim.lr,
            momentum=ctx.sim.momentum, local_steps=ctx.sim.local_steps)
        return ClientResult((padded, mask), float(ctx.sizes[client_id]),
                            comm_bytes=self._wire_for(ctx, r, mask))

    # ---------------------------------------------- batched capability
    def client_group_key(self, ctx, client_id):
        return float(min(ctx.ratios[client_id], 1.0))

    def client_update_batched(self, ctx, state, client_ids,
                              batches_per_client):
        r = min(ctx.ratios[client_ids[0]], 1.0)
        sub, sub_cfg = width_util.slice_resnet(state, ctx.model_cfg, r)
        locals_ = fedavg_local_batched(
            sub_cfg, sub, batches_per_client, lr=ctx.sim.lr,
            momentum=ctx.sim.momentum, local_steps=ctx.sim.local_steps)
        results = []
        for cid, local in zip(client_ids, locals_):
            padded, mask = width_util.pad_resnet(local, ctx.model_cfg,
                                                 sub_cfg)
            results.append(ClientResult(
                (padded, mask), float(ctx.sizes[cid]),
                comm_bytes=self._wire_for(ctx, r, mask)))
        return results

    def aggregate(self, ctx, state, results):
        return heterofl_aggregate(state,
                                  [r.payload[0] for r in results],
                                  [r.payload[1] for r in results],
                                  [r.weight for r in results])

    def aggregate_async(self, ctx, state, results, stalenesses, *,
                        alpha=0.5):
        """Coverage-aware staleness discount: each client's nested-slice
        weight is scaled by ``s(tau_k)`` inside the per-coordinate
        average, and the lost mass joins as a full-coverage anchor on the
        current global params — coordinates covered only by stale slices
        drift server-ward instead of snapping to stale values.  Zero
        staleness => anchor 0 => exactly ``aggregate``."""
        from repro_torch.fl.systime.staleness import polynomial_discount
        disc = [polynomial_discount(t, alpha) for t in stalenesses]
        padded = [r.payload[0] for r in results]
        masks = [r.payload[1] for r in results]
        weights = [r.weight * s for r, s in zip(results, disc)]
        anchor = sum(r.weight * (1.0 - s) for r, s in zip(results, disc))
        if anchor > 0.0:
            padded.append(state)
            masks.append(tree_map(torch.ones_like, state))
            weights.append(anchor)
        return heterofl_aggregate(state, padded, masks, weights)

    def eval_model(self, ctx, state, x, y):
        return common.image_accuracy(ctx.model_cfg, state, x, y)

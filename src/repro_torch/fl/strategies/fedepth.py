"""FeDepth (paper Algorithm 1) as an FLStrategy, LM path (port of
``repro.fl.strategies.fedepth`` with ``head="skip"``).

Composes: memory model -> per-client decomposition (precomputed in the
engine context) -> depth-wise sequential ClientUpdate -> plain FedAvg.
Clients below the finest block train partially (skipped prefix).  The
reference's MKD update is image-only (LM surplus clients take the plain
depth-wise update there too); m-FeDepth, FedProx, explicit runners,
masked aggregation and the batched / async hooks wait for later
slices.
"""
from __future__ import annotations

from repro_torch.core import aggregation, blockwise
from repro_torch.fl.registry import register
from repro_torch.fl.strategies import common
from repro_torch.fl.strategy import ClientResult
from repro_torch.models import build


@register("fedepth")
class FedepthStrategy:
    def __init__(self, head: str = "skip"):
        if head != "skip":
            raise NotImplementedError("m-FeDepth (head='aux') is not ported "
                                      "yet")
        self.head = head
        self.runner = None

    def setup(self, ctx):
        self.runner = blockwise.lm_runner(build(ctx.model_cfg),
                                          head=self.head)

    def init_state(self, ctx):
        return build(ctx.model_cfg).init(ctx.seed, device=ctx.device)

    def client_update(self, ctx, state, client_id, batches):
        local = blockwise.client_update(
            self.runner, state, ctx.decomps[client_id], batches,
            lr=ctx.sim.lr, momentum=ctx.sim.momentum,
            local_steps=ctx.sim.local_steps, prefix_cache=ctx.prefix_cache)
        return ClientResult(local, float(ctx.sizes[client_id]))

    def aggregate(self, ctx, state, results):
        return aggregation.fedavg([r.payload for r in results],
                                  [r.weight for r in results])

    def eval_model(self, ctx, state, x, y):
        return common.lm_accuracy(ctx.model_cfg, state, x, y)

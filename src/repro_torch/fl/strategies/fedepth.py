"""FeDepth / m-FeDepth (paper Algorithm 1) as an FLStrategy (port of
``repro.fl.strategies.fedepth``).

Composes: memory model -> per-client decomposition (precomputed in the
engine context) -> depth-wise sequential ClientUpdate -> plain FedAvg.
Variants:
  * ``head="skip"``  -> FeDepth   (skip-connection classifier)
  * ``head="aux"``   -> m-FeDepth (auxiliary classifiers; ResNet only —
    m-FeDepth on LMs is not ported yet)
  * surplus clients (M > 1)       -> MKD local update (core.mkd)
  * clients below the finest block -> partial training (skip prefix)

The same class backs the registered strategies (the ResNet runner for the
image protocol, the LM runner when ``model_cfg`` is a ``ModelConfig``) and
``core.fedepth.FedepthServer``'s model-agnostic path: pass an explicit
``runner`` (any BlockRunner), optional ``mkd_fns=(logits_fn,
task_loss_fn)`` for surplus clients, ``masked_aggregation=True`` for the
beyond-paper per-leaf reweighting and ``prox_mu`` for FedProx.  The
batched, shardable, async and wire hooks wait for their slices.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation, blockwise, mkd
from repro_torch.core.blockwise import BlockRunner
from repro_torch.fl.baselines import _ce
from repro_torch.fl.registry import register
from repro_torch.fl.strategies import common
from repro_torch.fl.strategy import ClientResult, wire_bytes
from repro_torch.models import build, resnet


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
            else:
                self.runner = blockwise.resnet_runner(ctx.model_cfg,
                                                      head=self.head)

    def init_state(self, ctx):
        if isinstance(ctx.model_cfg, ModelConfig):
            if self.head != "skip":
                raise NotImplementedError(
                    "m-FeDepth on LMs (aux_norms) is not ported yet")
            return build(ctx.model_cfg).init(ctx.seed, device=ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
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

    def aggregate(self, ctx, state, results):
        ws = [r.weight for r in results]
        if self.masked_aggregation:
            return aggregation.aggregate_masked(
                state, [r.payload[0] for r in results], ws,
                [r.payload[1] for r in results])
        return aggregation.fedavg([r.payload for r in results], ws)

    def eval_model(self, ctx, state, x, y):
        if isinstance(ctx.model_cfg, ModelConfig):
            return common.lm_accuracy(ctx.model_cfg, state, x, y)
        return common.resnet_accuracy(ctx.model_cfg, state, x, y)

    # ---------------------------------------------------------- MKD local
    def _mkd_update(self, ctx, state, batches, M: int):
        """Surplus clients train M models with mutual KD and upload one."""
        kw = dict(lr=ctx.sim.lr, momentum=ctx.sim.momentum,
                  local_steps=ctx.sim.local_steps)
        if self.mkd_fns is not None:       # model-agnostic (server) path
            logits_fn, task_fn = self.mkd_fns
            return mkd.mkd_local_update(logits_fn, task_fn, [state] * M,
                                        batches, **kw)[0]
        # ResNet path (aux heads ride along untouched)
        cfg = ctx.model_cfg

        def logits_fn(p, b):
            return resnet.apply(p, cfg, b["images"])

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


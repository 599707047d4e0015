"""DepthFL (Kim et al. 2023) as an FLStrategy (port of
``repro.fl.strategies.depthfl``): FIXED-depth prefix sub-models with
auxiliary classifiers, sized to memory budgets as the paper did
(footnote 2).  Unlike FeDepth the prefix backpropagates as a whole, so
its memory is the SUM over prefix blocks — the structural disadvantage
under tight budgets.

Two config families share the class:
  * ``ResNetConfig`` — the paper's image protocol: the state is
    ``(params, aux)``, aux classifiers every 2 blocks, per-block
    ``depth_aggregate`` and per-exit ``aux_aggregate``.
  * ``ModelConfig`` (the port's dense and ``ssm`` LMs) — the prefix is a
    single FeDepth block ``[0, depth)`` over the family's ``lm_runner``;
    the shared LM head plays the classifier, and aggregation masks by
    trained coverage.

On the wire the trained tree is delta-coded against the server's copy
(``wire_parts``), and a depth-d client's sliced downlink is its prefix
(``downlink_tree``).  Under system time a client is priced as one
end-to-end prefix block (``client_work``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation, blockwise
from repro_torch.core.decomposition import Decomposition
from repro_torch.fl.baselines import (depthfl_depth_for_budget,
                                      depthfl_init_aux, depthfl_local)
from repro_torch.fl.comm.payload import WireSpec
from repro_torch.fl.registry import register
from repro_torch.fl.strategies import common
from repro_torch.fl.strategy import ClientResult
from repro_torch.models import build, resnet
from repro_torch.tree import tree_map


def _prefix(depth: int) -> Decomposition:
    return Decomposition(((0, depth),), 0, 0)


@register("depthfl")
class DepthFLStrategy:
    runner = None  # the LM path's BlockRunner (set in setup)

    def _is_lm(self, ctx) -> bool:
        return isinstance(ctx.model_cfg, ModelConfig)

    def setup(self, ctx):
        if self._is_lm(ctx):
            if self.runner is None:
                self.runner = blockwise.lm_runner(build(ctx.model_cfg))
            n = self.runner.n_units
            # the deepest whole prefix [0, d) whose one-shot backprop
            # memory fits the budget (DepthFL trains it as one block)
            self.depths = [
                max([d for d in range(1, n + 1)
                     if ctx.mem.block_train_bytes(0, d) <= int(b)] or [1])
                for b in ctx.budgets]
            return
        self.depths = [depthfl_depth_for_budget(ctx.model_cfg, int(b),
                                                ctx.sim.mem_batch)
                       for b in ctx.budgets]

    def init_state(self, ctx):
        if self._is_lm(ctx):
            return build(ctx.model_cfg).init(ctx.seed, device=ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        params = resnet.init(gen, ctx.model_cfg, device=ctx.device)
        return params, depthfl_init_aux(ctx.model_cfg, gen,
                                        device=ctx.device)

    def client_depth(self, ctx, client_id) -> int:
        """The prefix depth client ``client_id`` trains: its budget's,
        floored at the first exit (2 blocks; 1 layer on an LM)."""
        floor = 1 if self._is_lm(ctx) else 2
        return max(self.depths[client_id], floor)

    def client_work(self, ctx, client_id):
        """System-time pricing: one end-to-end prefix of ``depth`` blocks
        — exactly a single-block FeDepth schedule [0, depth)."""
        return _prefix(self.client_depth(ctx, client_id))

    def client_update(self, ctx, state, client_id, batches):
        depth = self.client_depth(ctx, client_id)
        kw = dict(lr=ctx.sim.lr, momentum=ctx.sim.momentum,
                  local_steps=ctx.sim.local_steps)
        if self._is_lm(ctx):
            local = blockwise.client_update(
                self.runner, state, _prefix(depth), batches,
                prefix_cache=ctx.prefix_cache, **kw)
            return ClientResult((local, depth), float(ctx.sizes[client_id]))
        params, aux = state
        p, a, _ = depthfl_local(ctx.model_cfg, params, aux, depth, batches,
                                **kw)
        return ClientResult((p, a, depth), float(ctx.sizes[client_id]))

    # ------------------------------------------------- wire contract
    def wire_parts(self, ctx, state, result):
        """Delta-code the trained tree against the server's copy; blocks
        beyond the client's depth equal the broadcast copy, so their
        deltas are exact zeros.  The depth rides along uncompressed."""
        if self._is_lm(ctx):
            local, depth = result.payload
            return WireSpec(local, ref=state,
                            rebuild=lambda t, _d=depth: (t, _d))
        p, a, depth = result.payload
        return WireSpec((p, a), ref=state,
                        rebuild=lambda t, _d=depth: (t[0], t[1], _d))

    def downlink_tree(self, ctx, state, client_id):
        """Depth-wise downlink slice: a depth-d client needs only the
        prefix below d and the shared head (LM: the runner's trained
        subtree for [0, d); image: stem + d blocks + head + the aux exits
        it covers)."""
        depth = self.client_depth(ctx, client_id)
        if self._is_lm(ctx):
            return self.runner.split(state, 0, depth)
        params, aux = state
        sub = {k: params[k] for k in ("stem", "head_norm", "classifier")}
        sub["blocks"] = params["blocks"][:depth]
        sub_aux = {k: v for k, v in aux.items()
                   if int(k.split("_")[1]) <= depth}
        return (sub, sub_aux)

    def _lm_mask(self, ctx, state, depth):
        cache = ctx.caches.setdefault("depthfl_lm_masks", {})
        if depth not in cache:
            cache[depth] = aggregation.trained_mask_for(
                state, _prefix(depth), self.runner)
        return cache[depth]

    def aggregate(self, ctx, state, results):
        ws = [r.weight for r in results]
        if self._is_lm(ctx):
            return aggregation.aggregate_masked(
                state, [r.payload[0] for r in results], ws,
                [self._lm_mask(ctx, state, r.payload[1]) for r in results])
        params, aux = state
        covs = [r.payload[2] for r in results]
        params = depth_aggregate(ctx.model_cfg, params,
                                 [r.payload[0] for r in results], covs, ws)
        aux = aux_aggregate(aux, [r.payload[1] for r in results], covs, ws)
        return params, aux

    def eval_model(self, ctx, state, x, y):
        if self._is_lm(ctx):
            return common.lm_accuracy(ctx.model_cfg, state, x, y)
        return common.image_accuracy(ctx.model_cfg, state[0], x, y)


def _average(trees, weights):
    """``sum(w_i x_i)`` leaf-wise, the weights normalised in float32."""
    w = np.asarray(weights, np.float32)
    w = (w / w.sum()).tolist()
    with torch.no_grad():
        return tree_map(lambda *xs: aggregation._weighted_sum(w, xs),
                        *trees)


def depth_aggregate(cfg, global_params, locals_, coverages, weights):
    """Per-block aggregation over the clients whose depth covers the
    block (depth > b); the stem and the head over every client."""
    w = np.asarray(weights, np.float32)
    out = dict(global_params)
    for key in ("stem", "head_norm", "classifier"):
        out[key] = _average([lp[key] for lp in locals_], w)
    blocks = []
    for b in range(cfg.num_blocks):
        covered = [i for i, c in enumerate(coverages) if c > b]
        if not covered:
            blocks.append(global_params["blocks"][b])
            continue
        blocks.append(_average([locals_[i]["blocks"][b] for i in covered],
                               w[covered]))
    out["blocks"] = blocks
    return out


def aux_aggregate(aux, auxs, coverages, weights):
    """Per-exit aggregation over the clients whose depth reaches the exit
    (depth >= e); an exit nobody reached keeps its value."""
    w = np.asarray(weights, np.float32)
    out = dict(aux)
    for name in aux:
        e = int(name.split("_")[1])
        covered = [i for i, c in enumerate(coverages) if c >= e]
        if covered:
            out[name] = _average([auxs[i][name] for i in covered],
                                 w[covered])
    return out

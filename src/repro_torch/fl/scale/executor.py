"""``ShardedScheduler`` — cohort fan-out across the ``"data"`` axis's
devices (port of ``repro.fl.scale.executor``; docs/scale.md §Executor).

``VectorizedScheduler`` stacks a group of clients sharing one execution
signature into a single vmap dispatch on ONE device.  ``ShardedScheduler``
is its multi-device peer behind the same ``RoundEngine(scheduler=...)``
knob: the stacked client axis is split into chunks (``_chunk_widths``:
as even as possible, every width >= 2, never padded), one per device of
the data axis (``launch.mesh.make_data_mesh``: a list of
``torch.device``), each device runs the strategy's own group update
(:class:`~repro_torch.fl.strategy.ShardableFLStrategy.group_update_fn`,
the very function the vectorized path runs) over its chunk, and every
lane lands on the first device in cohort order.

The reference is single-controller too: one process dispatches every
chunk.  So is the port — no ``torch.distributed``, no second process.  On
a single device with ``max_lanes=None`` the one chunk IS the vectorized
dispatch, and lanes are bitwise the vectorized scheduler's.  Narrower
chunks run the same function over fewer lanes; whether that changes
lane bits depends on the backend's choice of algorithm for the group
count (the tests hold them on the CPU, ``chip_smoke.py`` on the card,
and say which held).  Strategies without the shardable hooks — and
groups that are too small / unstackable / ``None``-keyed — take the
vectorized scheduler's fallback chain.  An LM runner's chunk runs the
same group update, each kernel launched once a chunk (the vmap rules
of ``kernels/ops.py``); a stacked group never quietly runs
sequentially.

**Fused aggregation** (``aggregate="mesh"``): for masked depth-wise
strategies the round can fuse aggregation into the dispatch — each
device folds its chunk's lanes into (masked-sum, count) partials
mirroring :func:`repro_torch.core.aggregation.aggregate_masked`'s op
order (:func:`masked_partials`), the partials are summed on the first
device (:func:`psum_masked_partials`, the reference's ``psum`` over
``"data"``) and combined into the next state
(:func:`mesh_aggregate_masked`), so per-client full-size locals are never
materialized as results.  On one device with a single cohort group and a
single chunk the fused result is BITWISE ``aggregate_masked``; across
groups, chunks or devices partial sums reassociate and equality holds to
float tolerance.  ``RoundEngine`` probes ``run_fused`` only under
``codec="none"``, before any batch is drawn.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.blockwise import (batch_signature, broadcast_tree,
                                        stack_batches, stackable,
                                        unstack_tree)
from repro_torch.fl.sampling import VectorizedScheduler
from repro_torch.fl.strategy import ClientResult, wire_bytes
from repro_torch.obs import active as obs_active, span_if
from repro_torch.tree import tree_leaves, tree_map

# above this lane count a chunk's fold switches from the exact per-lane
# sum (``aggregate_masked``'s op order) to an axis reduction: at that
# scale the fused path's contract is tolerance-level anyway
FOLD_LANES_EXACT = 64


def _to(tree, device: torch.device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


# --------------------------------------------------------------------------
# masked aggregation primitives
# --------------------------------------------------------------------------
@torch.no_grad()
def masked_partials(locals_stacked, mask, weights: Sequence[float]):
    """One chunk's (num, den) partials: elementwise ``num = sum_i (w_i *
    m) * x_i`` and ``den = sum_i w_i * m`` over the chunk's stacked lanes.
    Up to :data:`FOLD_LANES_EXACT` lanes in ``aggregate_masked``'s order
    (each weight an fp32 value, each product rounded, added in lane
    order); beyond it one axis reduction.  ``mask`` is the group's shared
    trained-mask tree."""
    lanes = tree_leaves(locals_stacked)[0].shape[0]
    w = torch.tensor(list(weights), dtype=torch.float32)
    if lanes <= FOLD_LANES_EXACT:
        wl = w.tolist()

        def fold(m, x):
            den = m * wl[0]
            num = den * x[0].float()
            for i in range(1, lanes):
                wm = m * wl[i]
                num += wm * x[i].float()
                den += wm
            return num, den
    else:
        def fold(m, x):
            wd = w.to(x.device).reshape((lanes,) + (1,) * (x.dim() - 1))
            return ((wd * m) * x.float()).sum(0), float(w.sum()) * m

    pairs = tree_map(lambda m, x: fold(m.to(x.device), x), mask,
                     locals_stacked)
    num = tree_map(lambda m, p: p[0], mask, pairs)
    den = tree_map(lambda m, p: p[1], mask, pairs)
    return num, den


@torch.no_grad()
def psum_masked_partials(partials, device: torch.device):
    """The reference's ``psum`` over ``"data"``: the per-device (num, den)
    partials of one dispatch summed on ``device``.  One partial is
    returned as it is (on ``device``) — the identity of a 1-device
    psum."""
    num, den = _to(partials[0][0], device), _to(partials[0][1], device)
    for n, d in partials[1:]:
        num = tree_map(torch.add, num, _to(n, device))
        den = tree_map(torch.add, den, _to(d, device))
    return num, den


@torch.no_grad()
def mesh_aggregate_masked(global_params, partials):
    """Combine per-dispatch ``(num, den)`` partials into the next server
    state: ``num / max(den, 1e-12)``, leaves nobody trained keeping the
    global value.  Bitwise ``aggregation.aggregate_masked`` for a single
    partial (den > 0 iff some client trained the leaf: weights are
    |D_k| >= 1 and masks {0, 1})."""
    def one(g, *nd):
        n = len(nd) // 2
        num, den = nd[0], nd[n]
        for i in range(1, n):
            num = num + nd[i]
            den = den + nd[n + i]
        out = num / den.clamp(min=1e-12)
        return torch.where(den > 0, out, g.float()).to(g.dtype)

    nums = [p[0] for p in partials]
    dens = [p[1] for p in partials]
    return tree_map(one, global_params, *nums, *dens)


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------
class ShardedScheduler:
    """Multi-device peer of :class:`~repro_torch.fl.sampling
    .VectorizedScheduler` (``RoundEngine(scheduler="sharded")``).

    ``mesh`` is the data axis, a list of devices; it defaults to every
    visible CUDA device (``launch.mesh.make_data_mesh``), built lazily so
    that constructing the scheduler never touches a device.
    ``aggregate="mesh"`` opts into the fused aggregation path (module
    docstring); ``"host"`` (default) keeps the strategy's own
    ``aggregate``.  ``max_lanes`` caps the stacked client lanes per
    device in one dispatch — the peak-memory knob for large cohorts;
    chunks beyond the device count round-robin.  ``None`` keeps one
    chunk per device."""

    def __init__(self, min_group: int = 2, *, mesh=None,
                 aggregate: str = "host",
                 max_lanes: Optional[int] = None):
        if aggregate not in ("host", "mesh"):
            raise ValueError(f"aggregate must be 'host' or 'mesh', "
                             f"got {aggregate!r}")
        self.min_group = max(1, int(min_group))
        self.aggregate = aggregate
        self.max_lanes = None if max_lanes is None else max(2, int(max_lanes))
        self._mesh = None if mesh is None else [torch.device(d)
                                                for d in mesh]
        self.fallback = VectorizedScheduler(min_group)

    @property
    def mesh(self) -> List[torch.device]:
        if self._mesh is None:
            from repro_torch.launch.mesh import make_data_mesh
            self._mesh = make_data_mesh()
        return self._mesh

    # ------------------------------------------------------------ default
    def run(self, ctx, strategy, state, cohort, batch_fn):
        group_fn = getattr(strategy, "group_update_fn", None)
        group_results = getattr(strategy, "group_results", None)
        group_key = getattr(strategy, "client_group_key", None)
        if group_fn is None or group_results is None or group_key is None:
            return self.fallback.run(ctx, strategy, state, cohort, batch_fn)

        ids = [int(k) for k in cohort]
        batches = [batch_fn(k) for k in ids]   # cohort-order rng draws
        groups: dict = {}
        for pos, cid in enumerate(ids):
            groups.setdefault(group_key(ctx, cid), []).append(pos)

        obs = obs_active()
        results: List[Optional[ClientResult]] = [None] * len(ids)
        for key, positions in groups.items():
            group_batches = [batches[p] for p in positions]
            if (key is None or len(positions) < self.min_group
                    or not stackable(group_batches)):
                for p in positions:
                    with span_if(obs, "client-update", client=ids[p],
                                 fallback=True):
                        results[p] = strategy.client_update(
                            ctx, state, ids[p], batches[p])
                if obs is not None:
                    obs.metrics.counter("scheduler_fallback_clients",
                                        scheduler="sharded",
                                        ).inc(len(positions))
                continue
            gids = [ids[p] for p in positions]
            with span_if(obs, "cohort-group", size=len(gids),
                         signature=str(key), scheduler="sharded"):
                locals_ = self._run_group(ctx, strategy, state, gids,
                                          group_batches)
            if obs is not None:
                obs.metrics.counter("group_dispatches",
                                    scheduler="sharded").inc()
                obs.metrics.counter("group_clients",
                                    scheduler="sharded").inc(len(gids))
            for p, res in zip(positions,
                              group_results(ctx, state, gids, locals_)):
                results[p] = res
        return results

    @staticmethod
    def _chunk_widths(G: int, n_dev: int,
                      max_lanes: Optional[int] = None) -> List[int]:
        """Split a G-client group into dispatch chunks: as even as
        possible, every chunk width >= 2, no padding lanes ever.  At most
        ``n_dev`` chunks unless ``max_lanes`` forces more (then the extras
        round-robin the devices).  The reference's rule, unchanged."""
        if G == 1:
            return [1]
        d = min(n_dev, G // 2) if n_dev > 1 else 1
        if max_lanes is not None:
            d = min(max(d, -(-G // max_lanes)), G // 2)
        base, extra = divmod(G, d)
        return [base + (i < extra) for i in range(d)]

    def _chunks(self, gbatches):
        """``(device, start, width)`` of each chunk of a group."""
        devices = self.mesh
        out, start = [], 0
        for i, w in enumerate(self._chunk_widths(len(gbatches),
                                                 len(devices),
                                                 self.max_lanes)):
            out.append((devices[i % len(devices)], start, w))
            start += w
        return out

    def _dispatch(self, fn, state, gbatches, dev, start, w):
        """One chunk's stacked update on ``dev``: ``fn`` over ``w`` copies
        of the state and the chunk's stacked batches."""
        return fn(broadcast_tree(_to(state, dev), w),
                  _to(stack_batches(gbatches[start:start + w]), dev))

    def _run_group(self, ctx, strategy, state, gids, gbatches):
        """One group's locals, fanned out chunk per device; every lane
        lands on the first device, in cohort order (a copy, never a
        recompute: bits are preserved)."""
        fn = strategy.group_update_fn(ctx, gids)
        d0 = self.mesh[0]
        out = []
        for dev, start, w in self._chunks(gbatches):
            stacked = self._dispatch(fn, state, gbatches, dev, start, w)
            out.extend(_to(t, d0) for t in unstack_tree(stacked, w))
        return out

    # -------------------------------------------------------------- fused
    def run_fused(self, ctx, strategy, state, cohort, batch_fn):
        """One round's local updates AND masked aggregation, fused.
        Returns ``(new_state, comm_bytes)`` or ``NotImplemented`` when
        ineligible — probed by ``RoundEngine`` BEFORE any batch is drawn,
        so a fall-through never draws from the shared stream.
        Eligibility: ``aggregate="mesh"``, a shardable strategy with
        masked aggregation (``group_mask`` not ``None``), and no
        sequential-only (``None``-keyed) clients.

        Uplink accounting: each client's upload still crossed the
        simulated wire — priced as ``wire_bytes(state)`` per client,
        exact for the state-congruent full-model payloads masked
        depth-wise strategies send."""
        if self.aggregate != "mesh":
            return NotImplemented
        group_fn = getattr(strategy, "group_update_fn", None)
        mask_fn = getattr(strategy, "group_mask", None)
        group_key = getattr(strategy, "client_group_key", None)
        if group_fn is None or mask_fn is None or group_key is None:
            return NotImplemented

        ids = [int(k) for k in cohort]
        keys = {cid: group_key(ctx, cid) for cid in ids}
        if any(v is None for v in keys.values()):
            return NotImplemented
        if mask_fn(ctx, state, ids[0]) is None:   # unmasked aggregation
            return NotImplemented

        batches = [batch_fn(k) for k in ids]   # cohort-order rng draws
        groups: dict = {}
        for pos, cid in enumerate(ids):
            groups.setdefault(keys[cid], []).append(pos)

        # max_lanes bounds lanes per device in one dispatch, so a group
        # may split into several sub-dispatches — their (num, den)
        # partials compose exactly (the combine sums partials)
        cap = (None if self.max_lanes is None
               else self.max_lanes * len(self.mesh))
        obs = obs_active()
        partials = []
        for key, positions in groups.items():
            gids = [ids[p] for p in positions]
            gbatches = [batches[p] for p in positions]
            mask = mask_fn(ctx, state, gids[0])
            w = [float(ctx.sizes[c]) for c in gids]
            # population batch counts track |D_k|, so one budget group
            # holds several stackable sub-cohorts — split by per-client
            # batch signature; only singleton signatures run alone
            by_sig: dict = {}
            for i, b in enumerate(gbatches):
                by_sig.setdefault(batch_signature(b), []).append(i)
            for idxs in by_sig.values():
                s_ids = [gids[i] for i in idxs]
                s_b = [gbatches[i] for i in idxs]
                s_w = [w[i] for i in idxs]
                if len(idxs) < 2:
                    if obs is not None:
                        obs.metrics.counter("scheduler_fallback_clients",
                                            scheduler="sharded",
                                            ).inc(len(idxs))
                    partials.append(self._host_partial(
                        ctx, strategy, state, s_ids, s_b, mask, s_w))
                    continue
                step = cap or len(s_ids)
                for s in range(0, len(s_ids), step):
                    with span_if(obs, "cohort-group",
                                 size=len(s_ids[s:s + step]),
                                 signature=str(key), scheduler="sharded"):
                        partials.append(self._mesh_partial(
                            ctx, strategy, state, s_ids[s:s + step],
                            s_b[s:s + step], mask, s_w[s:s + step]))
                    if obs is not None:
                        obs.metrics.counter("group_dispatches",
                                            scheduler="sharded").inc()
        comm = len(ids) * wire_bytes(state)
        return mesh_aggregate_masked(state, partials), comm

    def _mesh_partial(self, ctx, strategy, state, gids, gbatches, mask, w):
        """One dispatch's partial: each chunk's lanes folded on its
        device, the chunk partials summed on the first device."""
        fn = strategy.group_update_fn(ctx, gids)
        chunk_partials = []
        for dev, start, width in self._chunks(gbatches):
            stacked = self._dispatch(fn, state, gbatches, dev, start, width)
            chunk_partials.append(masked_partials(
                stacked, _to(mask, dev), w[start:start + width]))
            del stacked
        return psum_masked_partials(chunk_partials, self.mesh[0])

    def _host_partial(self, ctx, strategy, state, gids, gbatches, mask, w):
        """Clients that cannot stack: per-client sequential updates,
        folded with the same ops in chunks of ``FOLD_LANES_EXACT``
        clients — composes with the dispatch partials."""
        locals_ = []
        for cid, b in zip(gids, gbatches):
            payload = strategy.client_update(ctx, state, cid, b).payload
            locals_.append(payload[0] if isinstance(payload, tuple)
                           else payload)
        d0 = self.mesh[0]
        partials = []
        for s in range(0, len(locals_), FOLD_LANES_EXACT):
            lanes = locals_[s:s + FOLD_LANES_EXACT]
            stacked = tree_map(lambda *xs: torch.stack(xs), *lanes)
            partials.append(masked_partials(stacked, mask,
                                            w[s:s + FOLD_LANES_EXACT]))
        return psum_masked_partials(partials, d0)

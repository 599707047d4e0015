"""The ``FLStrategy`` protocol (port of ``repro.fl.strategy``).

Every method is a strategy with four hooks; one ``RoundEngine``
(:mod:`repro_torch.fl.engine`) owns cohort sampling, budget /
decomposition assignment, eval cadence and the structured history.  A
strategy with the two hooks of :class:`BatchableFLStrategy` can be run by
the vectorized scheduler.  A strategy may also declare its wire
(``wire_parts`` / ``downlink_tree``, :mod:`repro_torch.fl.comm`), its
system-time work (``client_work``, priced by
:mod:`repro_torch.fl.systime.profiles`) and a staleness-aware merge
(:class:`AsyncFLStrategy`).  The shardable capability is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Protocol, \
    Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.tree import tree_bytes


@dataclasses.dataclass
class ClientResult:
    """What one client hands back to the server; ``payload`` is
    strategy-defined (the full param tree for FeDepth)."""
    payload: Any
    weight: float                       # aggregation weight ~ |D_k|
    comm_bytes: Optional[int] = None    # upload size; None -> engine sizes
                                        # the payload itself
    client_id: Optional[int] = None     # stamped by the engines so an
                                        # async merge can look up the
                                        # sender's decomposition / ratio


@dataclasses.dataclass
class Context:
    """Everything the engine precomputes once per experiment and shares
    with the strategy on every hook call.

    ``seed`` seeds the port's own model init (the reference's PRNG key);
    ``device`` is where parameters and data live (the reference's
    ``kernel_force``: the kernels follow the tensors' device).
    ``rng`` is the shared numpy simulation stream, drawn in the
    reference's order so cohorts and batches match it exactly."""
    sim: Any                                 # SimConfig (engine module)
    num_clients: int
    sizes: np.ndarray                        # per-client sample counts
    rng: np.random.Generator                 # shared simulation stream
    seed: int                                # model init seed
    device: torch.device
    model_cfg: Any = None
    mem: Any = None                          # ModelMemory (budget pricing)
    ratios: Optional[np.ndarray] = None      # scenario width ratios
    budgets: Optional[np.ndarray] = None     # bytes per client
    decomps: Optional[List] = None           # Decomposition per client
    surplus: Optional[np.ndarray] = None     # per-client local model count M
                                             # (M > 1 -> MKD client)
    data: Any = None
    # per-experiment memos of the strategies (e.g. HeteroFL's upload size
    # per ratio): kept here, never on a reusable strategy instance
    caches: Dict = dataclasses.field(default_factory=dict)
    # depth-wise execution contract: buffer the frozen-prefix activation
    # once per distinct batch per subproblem (True) or replay the prefix
    # in every SGD step (False) — ``RoundEngine(prefix_cache=...)``
    prefix_cache: bool = True
    # whether the active runner's prefix params are stable across
    # subproblems (``BlockRunner.prefix_stable``): the fallback for direct
    # ``SystemModel.latency`` callers (``AsyncEngine`` passes the
    # strategy runner's own flag)
    prefix_stable: bool = True


@runtime_checkable
class FLStrategy(Protocol):
    """Protocol every FL method implements.  A strategy may also define
    ``setup(ctx)``, called once before the round loop, also when the
    caller supplies an ``initial_state``."""

    def init_state(self, ctx: Context) -> Any:
        ...

    def client_update(self, ctx: Context, state: Any, client_id: int,
                      batches: Sequence) -> ClientResult:
        ...

    def aggregate(self, ctx: Context, state: Any,
                  results: Sequence[ClientResult]) -> Any:
        ...

    def eval_model(self, ctx: Context, state: Any, x, y) -> float:
        ...


@runtime_checkable
class BatchableFLStrategy(FLStrategy, Protocol):
    """Optional capability: cohort-vectorized local updates.

    :class:`repro_torch.fl.sampling.VectorizedScheduler` groups the
    cohort by ``client_group_key`` and runs each group's local work as
    one stacked (vmap-over-clients) computation through
    ``client_update_batched``.  Strategies without the hooks (or
    ``None`` keys) run per client — batching is an optimization, never a
    requirement."""

    def client_group_key(self, ctx: Context, client_id: int):
        """Hashable execution signature: clients with equal keys run the
        SAME computation and may be stacked; ``None`` opts the client
        out of batching."""
        ...

    def client_update_batched(self, ctx: Context, state: Any,
                              client_ids: Sequence[int],
                              batches_per_client: Sequence[Sequence]
                              ) -> List["ClientResult"]:
        """Local updates of a group sharing one key: equivalent to
        ``client_update`` per client (modulo float associativity),
        results in ``client_ids`` order."""
        ...


@runtime_checkable
class ShardableFLStrategy(BatchableFLStrategy, Protocol):
    """Optional capability: group updates a device fan-out can dispatch.

    A batchable strategy that also exposes its group update as a
    function can be driven by
    ``repro_torch.fl.scale.executor.ShardedScheduler``, which runs that
    very function on chunks of the group, one chunk per device.
    Strategies without these hooks are delegated to the vectorized
    scheduler wholesale."""

    def group_update_fn(self, ctx: Context,
                        client_ids: Sequence[int]) -> Callable:
        """The ``(stacked_params, stacked_batches) -> stacked_locals``
        update this group runs — the function ``client_update_batched``
        runs, valid for any group sharing ``client_group_key``."""
        ...

    def group_results(self, ctx: Context, state: Any,
                      client_ids: Sequence[int],
                      locals_: Sequence) -> List["ClientResult"]:
        """Wrap per-client updated trees into ``ClientResult``s, in
        ``client_ids`` order — the result-shaping half of
        ``client_update_batched``."""
        ...

    def group_mask(self, ctx: Context, state: Any, client_id: int):
        """The trained-mask tree a masked aggregation uses for this
        client (shared across a ``client_group_key`` group), or ``None``
        when the strategy aggregates unmasked."""
        ...


@runtime_checkable
class AsyncFLStrategy(FLStrategy, Protocol):
    """Optional capability: staleness-aware asynchronous aggregation.

    :class:`repro_torch.fl.systime.AsyncEngine` buffers results as
    client-finish events fire and, once the buffer fills, merges them with
    this hook; each result carries its *staleness*, the number of server
    versions applied since the snapshot it trained on (FedBuff's
    measure).  Strategies without the hook get
    :func:`repro_torch.fl.systime.staleness.default_aggregate_async`:
    weights discounted by the polynomial rule, then the strategy's own
    synchronous ``aggregate``."""

    def aggregate_async(self, ctx: Context, state: Any,
                        results: Sequence["ClientResult"],
                        stalenesses: Sequence[int], *,
                        alpha: float = 0.5) -> Any:
        """Fold one buffered batch of (result, staleness) into the next
        server state.  MUST equal ``aggregate`` when every staleness is
        0."""
        ...


def wire_bytes(tree=None, *, codec=None,
               n_coords: Optional[int] = None) -> int:
    """The sizing rule for payload wire cost.

    * ``codec`` ``None`` / ``"none"``: raw pricing — 4 bytes (fp32) per
      coordinate of a padded carrier's ``n_coords`` active
      coordinates (HeteroFL prices its width slice, never the zero
      padding), else the bytes of every tensor leaf.
    * any other codec (a name or an instance): the codec's
      ``size_bytes``.  Under an active ``CommChannel`` the engine
      overwrites this estimate with the exact encoded size.

    The engine sizes a payload this way when a strategy leaves
    ``ClientResult.comm_bytes`` at ``None``."""
    if codec is not None and codec != "none":
        from repro_torch.fl.comm.codecs import get_codec
        return get_codec(codec).size_bytes(tree, n_coords=n_coords)
    if n_coords is not None:
        return 4 * int(n_coords)
    return tree_bytes(tree)


@torch.no_grad()
def accuracy(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor,
             batch: int = 512) -> float:
    """Batched top-1 accuracy for any ``logits_fn(x) -> (B, C)``."""
    correct = 0
    for i in range(0, len(x), batch):
        logits = logits_fn(x[i:i + batch])
        correct += int((logits.argmax(-1) == y[i:i + batch]).sum())
    return correct / len(x)

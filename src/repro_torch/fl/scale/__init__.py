"""Population-scale cohort execution (port of ``repro.fl.scale``;
docs/scale.md).

* :mod:`~repro_torch.fl.scale.executor` — ``ShardedScheduler``, a peer
  of ``VectorizedScheduler`` behind the same ``RoundEngine(scheduler=)``
  knob: each cohort group's stacked update is split across the data
  axis's devices, and (opt-in) the masked depth-wise aggregation fuses
  into the dispatch as (masked-sum, count) partials.
* :mod:`~repro_torch.fl.scale.state_store` — the ``ClientStateStore``
  protocol with ``InMemoryStore``, ``PrefixedStore`` and ``SpillStore``
  (an LRU-bounded hot set, spilled to disk) backing error-feedback
  residuals, the downlink tracker, availability phases and async
  in-flight snapshots; also the engines' checkpoint blobs.
* :mod:`~repro_torch.fl.scale.population` — trace-driven populations:
  per-client ratio / size / profile / availability drawn lazily from a
  seeded counter-based hash, never materializing N entries; wired
  through ``build_context(..., population=)``.
* :mod:`~repro_torch.fl.scale.history` — the JSONL ``RoundRecord`` /
  trace sink both engines accept through ``history_sink=``.
"""
from repro_torch.fl.scale.executor import (FOLD_LANES_EXACT,
                                           ShardedScheduler,
                                           masked_partials,
                                           mesh_aggregate_masked,
                                           psum_masked_partials)
from repro_torch.fl.scale.history import JsonlHistorySink
from repro_torch.fl.scale.population import (HashedDutyCycle, Population,
                                             PopulationData,
                                             PopulationSampler,
                                             population_context,
                                             population_system)
from repro_torch.fl.scale.state_store import (ClientStateStore,
                                              InMemoryStore, PrefixedStore,
                                              SpillStore)

__all__ = [
    "ShardedScheduler", "mesh_aggregate_masked", "psum_masked_partials",
    "masked_partials", "FOLD_LANES_EXACT", "JsonlHistorySink",
    "Population", "PopulationData", "PopulationSampler", "HashedDutyCycle",
    "population_context", "population_system",
    "ClientStateStore", "InMemoryStore", "SpillStore", "PrefixedStore",
]

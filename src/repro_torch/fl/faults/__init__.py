"""Deterministic fault injection + engine resilience (port of
``repro.fl.faults``).

    from repro_torch.fl.faults import FaultPlan, ResiliencePolicy

    eng = RoundEngine(strategy, ctx,
                      faults=FaultPlan(seed=7, crash_rate=0.1),
                      resilience=ResiliencePolicy(max_retries=2),
                      checkpoint_dir="ckpts", checkpoint_every=5)
    eng2 = RoundEngine(strategy, ctx, ..., resume="ckpts")

``faults=None`` and ``resilience=None`` keep every fault-free engine
code path bitwise identical.
"""
from repro_torch.fl.faults.checkpointing import EngineCheckpointer
from repro_torch.fl.faults.plan import (FAULT_KINDS, PAYLOAD_KINDS,
                                        TRANSIENT_KINDS, Fault,
                                        FaultInjector, FaultPlan,
                                        as_injector)
from repro_torch.fl.faults.quarantine import (UpdateValidator, Verdict,
                                              tree_finite_max, update_norm)
from repro_torch.fl.faults.resilience import (DEGRADATION_MODES,
                                              AttemptOutcome, FaultRuntime,
                                              ResiliencePolicy)

__all__ = [
    "FAULT_KINDS", "TRANSIENT_KINDS", "PAYLOAD_KINDS",
    "Fault", "FaultPlan", "FaultInjector", "as_injector",
    "UpdateValidator", "Verdict", "tree_finite_max", "update_norm",
    "ResiliencePolicy", "AttemptOutcome", "FaultRuntime",
    "DEGRADATION_MODES", "EngineCheckpointer",
]

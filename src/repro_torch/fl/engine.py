"""The FL round engine (port of ``repro.fl.engine``).

One loop owns cohort sampling, the paper's budget / decomposition
assignment, eval cadence and a structured history of
``RoundRecord(round, accuracy, seconds, comm_bytes)``.

Budget protocol (paper §Memory budgets): client memory budgets are the
width-ratio-equivalent training footprints of PreResNet at batch 128,
r uniformly distributed over the scenario's tuple (``SCENARIOS``; the
full protocol is ``docs/budget_protocol.md``).  :func:`build_context`
prepares the paper's image protocol; ``fl/seq.py`` the LM one.

The engine runs the sequential (default) or the vectorized scheduler,
and routes every uplink and downlink byte through a
:class:`~repro_torch.fl.comm.CommChannel` (``codec`` / ``downlink``).
``faults`` / ``resilience`` (:mod:`repro_torch.fl.faults`) inject seeded
client faults and turn on retries, quarantine and cohort-shortfall
degradation; ``checkpoint_every`` / ``checkpoint_dir`` /
``checkpoint_keep`` / ``resume`` write crash-safe checkpoints and
continue a killed run bitwise.  ``history_sink`` streams the history to
a JSONL file (``repro_torch.fl.scale.history``), ``obs`` turns on the
telemetry layer (``repro_torch.obs``), and ``build_context(population=)``
builds the context of a lazily drawn client population
(``repro_torch.fl.scale.population``).  The system-time engine is
:class:`repro_torch.fl.systime.AsyncEngine`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.core.decomposition import decompose, width_equivalent_budget
from repro_torch.core.memory_model import resnet_memory
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.comm import CommChannel
from repro_torch.fl.sampling import (CohortSampler, UniformSampler,
                                     make_scheduler)
from repro_torch.fl.strategy import ClientResult, Context, FLStrategy, \
    wire_bytes
from repro_torch.obs import make_obs, scope, span_if

SCENARIOS: Dict[str, Tuple[float, ...]] = {
    "fair": (1 / 6, 1 / 3, 1 / 2, 1.0),
    "lack": (1 / 8, 1 / 6, 1 / 2, 1.0),
    "surplus": (1 / 6, 1 / 3, 1 / 2, 2.0),
}

# decomposition slack: the paper's Table 1 protocol carries implicit
# headroom (docs/budget_protocol.md)
BUDGET_SLACK = 1.20


@dataclasses.dataclass
class SimConfig:
    rounds: int = 20
    participation: float = 0.1
    lr: float = 0.05
    momentum: float = 0.9
    local_steps: int = 2
    batch_size: int = 64
    mem_batch: int = 128          # batch used to price memory (paper: 128)
    scenario: str = "fair"
    seed: int = 0


class RoundRecord(NamedTuple):
    """One history entry; ``seconds`` and ``comm_bytes`` / ``down_bytes``
    accumulate since the previous record (see the reference)."""
    round: int
    accuracy: Optional[float]
    seconds: float
    comm_bytes: int
    sim_seconds: float = 0.0
    down_bytes: int = 0


def client_ratios(num_clients: int, scenario: str,
                  seed: int = 0) -> np.ndarray:
    """The scenario's ratios over clients: uniform multiset, assignment
    seeded-shuffled."""
    rs = SCENARIOS[scenario]
    reps = int(np.ceil(num_clients / len(rs)))
    arr = np.tile(np.asarray(rs), reps)[:num_clients]
    np.random.default_rng(seed).shuffle(arr)
    return arr


def scenario_budgets(mem, ratios) -> np.ndarray:
    """Width-equivalent byte budgets for the scenario's ratio vector,
    floored at the finest unit + head."""
    floor = min(mem.block_train_bytes(i, i + 1)
                for i in range(len(mem.units)))
    return np.array([max(width_equivalent_budget(mem, min(r, 1.0))
                         * BUDGET_SLACK, floor) for r in ratios])


def build_context(data, sim: SimConfig, *,
                  model_cfg: Optional[ResNetConfig] = None,
                  device: DeviceLike = None, population=None) -> Context:
    """The per-experiment context of the paper's image protocol: ratios,
    byte budgets, FeDepth decompositions and MKD flags (M = 2 for r >= 2),
    on ``device`` (the GPU unless ``"cpu"``; the data must already live
    there).

    With ``population=`` (a ``repro_torch.fl.scale.population
    .Population``) the per-client arrays become LAZY hash-drawn views and
    ``data`` may be ``None`` (batches synthesized on demand) — nothing
    O(num_clients) is built; see docs/scale.md."""
    if population is not None:
        from repro_torch.fl.scale.population import population_context
        return population_context(population, sim, model_cfg=model_cfg,
                                  data=data, device=device)
    dev = resolve_device(device)
    if data.device.type != dev.type:
        raise ValueError(f"data lives on {data.device}, context on {dev}")
    num_clients = len(data.client_indices)
    cfg = model_cfg or ResNetConfig(num_classes=data.num_classes,
                                    image_size=data.x.shape[1])
    ratios = client_ratios(num_clients, sim.scenario, sim.seed)
    mem = resnet_memory(cfg, sim.mem_batch)
    budgets = scenario_budgets(mem, ratios)
    return Context(
        sim=sim, num_clients=num_clients, sizes=data.client_sizes(),
        rng=np.random.default_rng(sim.seed), seed=sim.seed, device=dev,
        model_cfg=cfg, mem=mem, ratios=ratios, budgets=budgets,
        decomps=[decompose(mem, int(b)) for b in budgets],
        surplus=np.where(ratios >= 2.0, 2, 1), data=data)


def default_batch_fn(ctx: Context) -> Callable[[int], list]:
    """The paper's per-round local loader: |D_k|/B fresh batches, drawn
    from the shared simulation stream."""
    data, sim = ctx.data, ctx.sim

    def batch_fn(k: int) -> list:
        return [data.client_batch(k, sim.batch_size, ctx.rng)
                for _ in range(max(1, len(data.client_indices[k])
                                   // sim.batch_size))]
    return batch_fn


def eval_state(strategy: FLStrategy, ctx: Context, state,
               eval_fn: Optional[Callable]) -> Optional[float]:
    """Explicit ``eval_fn`` > the strategy's eval on the test split >
    ``None``."""
    if eval_fn is not None:
        return eval_fn(state)
    if ctx.data is not None:
        return strategy.eval_model(ctx, state, ctx.data.x_test,
                                   ctx.data.y_test)
    return None


def _resolve_prefix_cache(spec) -> bool:
    if isinstance(spec, bool):
        return spec
    if spec not in ("on", "off"):
        raise ValueError(f"prefix_cache must be 'on' or 'off', got {spec!r}")
    return spec == "on"


def apply_prefix_cache(ctx: Context, spec) -> Context:
    """Resolve a ``prefix_cache`` knob onto a context: ``ctx`` itself when
    the contract already matches, else a shallow copy with the flag
    flipped (a shared context is never mutated)."""
    resolved = _resolve_prefix_cache(spec)
    if resolved == ctx.prefix_cache:
        return ctx
    return dataclasses.replace(ctx, prefix_cache=resolved)


def resolve_history_sink(spec, mode: str = "w") -> Tuple[object, bool]:
    """Resolve an engine's ``history_sink`` knob: ``None`` and sink
    instances pass through caller-owned; a PATH becomes an engine-owned
    ``JsonlHistorySink`` the engine closes when ``run()`` completes (a
    caller's instance is only flushed, never closed).  Returns ``(sink,
    engine_owns_it)``.  ``mode="a"`` appends instead of truncating — the
    resume path, where the stream already holds the earlier records."""
    if spec is None or hasattr(spec, "write"):
        return spec, False
    from repro_torch.fl.scale.history import JsonlHistorySink
    return JsonlHistorySink(spec, mode=mode), True


def close_history_sink(sink, owned: bool) -> None:
    """The engines' completion contract: an owned (path) sink closes, a
    caller's sink is flushed — it may outlive the run."""
    if sink is None:
        return
    if owned:
        sink.close()
    elif hasattr(sink, "flush"):
        sink.flush()


def resolve_faults(faults, resilience):
    """Resolve the engines' ``faults=`` / ``resilience=`` knobs into one
    ``FaultRuntime``.  With both off it injects nothing, validates
    nothing and degrades nothing (``FaultRuntime.enabled`` is False)."""
    from repro_torch.fl.faults import FaultRuntime
    return FaultRuntime(faults, resilience)


def resolve_checkpointing(every, ckpt_dir, keep, resume):
    """Resolve the engines' checkpoint / resume knobs into
    ``(EngineCheckpointer | None, resume_dir | None)``."""
    if every is not None and ckpt_dir is None:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    resume_dir = None
    if resume:
        resume_dir = resume if isinstance(resume, str) else ckpt_dir
        if resume_dir is None:
            raise ValueError("resume=True requires checkpoint_dir "
                             "(or pass the directory as resume=)")
    if every is None and resume_dir is None:
        return None, None
    from repro_torch.fl.faults import EngineCheckpointer
    ckpt = EngineCheckpointer(ckpt_dir, every, keep=keep) \
        if every is not None else None
    return ckpt, resume_dir


def load_resume(resume_dir, device):
    """The newest usable checkpoint pair in ``resume_dir`` as
    ``(round_idx, server_state, aux)``, its tensors on ``device``, or
    ``None`` (a fresh start when the directory is empty)."""
    from repro_torch.fl.faults import EngineCheckpointer
    return EngineCheckpointer(resume_dir, every=1).load_latest(device)


class RoundEngine:
    """Runs communication rounds of ONE strategy over a client
    population."""

    def __init__(self, strategy: FLStrategy, ctx: Context, *,
                 sampler: Optional[CohortSampler] = None,
                 scheduler=None, prefix_cache="on", codec="none",
                 downlink: str = "full",
                 channel: Optional[CommChannel] = None,
                 history_sink=None, obs=None,
                 faults=None, resilience=None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_keep: int = 3,
                 resume: Union[bool, str, None] = None):
        """``prefix_cache`` ("on" / "off") and ``scheduler`` (a name of
        ``fl.sampling.SCHEDULERS`` or an instance; sequential by default)
        as in the reference.  ``codec`` (a name of ``fl.comm.CODECS`` or
        a configured codec) and ``downlink`` ("full", "sliced" or
        "delta") configure the wire: lossy codecs run behind per-client
        error feedback and the history counts the exact encoded bytes;
        ``codec="none"`` with ``downlink="full"`` is the channel-free
        engine exactly.  A prebuilt ``channel`` wins over the two knobs.

        ``faults`` (a ``fl.faults.FaultPlan``) injects seeded client
        faults into every dispatch; ``resilience`` (a
        ``ResiliencePolicy``) turns on retry-with-backoff, update
        quarantine and cohort-shortfall degradation.  Both ``None`` keep
        the fault-free round bitwise.  ``checkpoint_every`` /
        ``checkpoint_dir`` write a crash-safe checkpoint pair every N
        rounds (server state + rng / channel / validator / history aux,
        ``checkpoint_keep`` of them retained); ``resume`` (``True`` =
        from ``checkpoint_dir``, or a directory) continues a killed run
        bitwise.

        ``history_sink`` (a ``repro_torch.fl.scale.JsonlHistorySink``, or
        a PATH the engine opens one at, owns and closes when ``run``
        completes) streams each :class:`RoundRecord` as it is produced;
        ``run`` then returns an empty history (the stream IS the
        history).  ``obs`` ("on" / "off" / "full" / a bool, or a shared
        ``repro_torch.obs.Obs``) turns on the telemetry layer for the
        dynamic extent of ``run`` / ``run_round``: spans, metrics and,
        with "full", the memory auditor and the dynamics analyzer.  Off,
        every instrumented site does one lookup and nothing else; on,
        results are bitwise the same (docs/observability.md)."""
        self.strategy = strategy
        self.ctx = apply_prefix_cache(ctx, prefix_cache)
        self.sampler = sampler or UniformSampler()
        self.scheduler = make_scheduler(scheduler)
        self.channel = channel or CommChannel(codec, downlink)
        self._faultrt = resolve_faults(faults, resilience)
        self._ckpt, self._resume_dir = resolve_checkpointing(
            checkpoint_every, checkpoint_dir, checkpoint_keep, resume)
        self.history_sink, self._owns_sink = resolve_history_sink(
            history_sink, mode="a" if self._resume_dir else "w")
        self.obs = make_obs(obs)
        if self.obs is not None:
            # attach the diagnostics (memory auditor / dynamics analyzer)
            # to this experiment — a no-op on plain captures
            self.obs.bind(self.ctx)

    def default_batch_fn(self) -> Callable[[int], list]:
        return default_batch_fn(self.ctx)

    def run_round(self, state, round_idx: int,
                  batch_fn: Callable[[int], list]):
        """One round (:meth:`_run_round`).  With ``obs`` on this is the
        telemetry boundary for direct callers too: the round runs inside
        a ``round`` span with the capture active, and the engine's byte
        counters accumulate."""
        if self.obs is None:
            return self._run_round(state, round_idx, batch_fn)
        with scope(self.obs), \
                self.obs.tracer.span("round", round=round_idx,
                                     engine="round"):
            state, comm, down = self._run_round(state, round_idx, batch_fn)
        m = self.obs.metrics
        m.counter("engine_rounds", engine="round").inc()
        m.counter("engine_up_bytes", engine="round").inc(comm)
        m.counter("engine_down_bytes", engine="round").inc(down)
        return state, comm, down

    def _run_round(self, state, round_idx: int,
                   batch_fn: Callable[[int], list]):
        """One round: broadcast (downlink accounting) -> sample -> local
        updates -> per client: fault resolution (payload damage / retry
        loop / give up) -> EF snapshot -> encode -> decode -> quarantine
        validation (a rejected update rolls the EF residual back, so its
        transmitted mass is retransmitted later; its bytes still count)
        -> aggregate the survivors.  Returns (new_state, up_bytes,
        down_bytes).  A cohort shortfall is handled by the policy's
        degradation mode; an empty surviving set leaves the state as it
        is (a no-op round, never a crash).  With ``faults`` and
        ``resilience`` off every step past the local update passes its
        result through, and the round is the fault-free one.

        Fault-free and under ``codec="none"``, a scheduler with a fused
        path (``ShardedScheduler(aggregate="mesh")``) is offered the
        round first, before any batch is drawn: ``NotImplemented`` falls
        through to the standard path with the shared stream untouched."""
        ctx, chan, rt = self.ctx, self.channel, self._faultrt
        cohort = [int(k) for k in self.sampler.sample(ctx, round_idx)]
        target = len(cohort)
        cohort = rt.overprovision(ctx, cohort)
        down = sum(chan.downlink_bytes(self.strategy, ctx, state, k)
                   for k in cohort)
        fused = getattr(self.scheduler, "run_fused", None)
        if fused is not None and not rt.enabled \
                and chan.codec.name == "none":
            out = fused(ctx, self.strategy, state, cohort, batch_fn)
            if out is not NotImplemented:
                new_state, comm = out
                return new_state, comm, down
        comm = 0
        kept: List[ClientResult] = []
        obs = self.obs

        def process(clients) -> int:
            nonlocal comm
            delivered = 0
            results = self.scheduler.run(ctx, self.strategy, state,
                                         clients, batch_fn)
            for k, res in zip(clients, results):
                res.client_id = k
                outcome = rt.resolve(
                    round_idx, k, res,
                    lambda k=k: self.strategy.client_update(
                        ctx, state, k, batch_fn(k)))
                if not outcome.delivered:
                    continue
                ef_snap = chan.snapshot_uplink(k)
                enc = chan.encode_result(self.strategy, ctx, state, k,
                                         outcome.result)
                comm += enc.comm_bytes if enc.comm_bytes is not None \
                    else wire_bytes(enc.payload)
                dec = chan.decode_result(enc)
                verdict = rt.validate_one(dec.payload, state)
                if verdict is not None:
                    chan.rollback_uplink(k, ef_snap)
                    rt.record_quarantine(k, verdict)
                    if obs is not None and obs.dynamics is not None:
                        obs.dynamics.record_rejection(
                            round_idx, k, verdict.reason, engine="round")
                    continue
                kept.append(dec)
                delivered += 1
            return delivered

        missing = target - process(cohort)
        if missing > 0:
            rt.record_shortfall(missing)
            extra = rt.resample(ctx, cohort, missing)
            if extra:
                down += sum(chan.downlink_bytes(self.strategy, ctx,
                                                state, k) for k in extra)
                process(extra)
        if kept:
            new_state = self.strategy.aggregate(ctx, state, kept)
            if obs is not None and obs.dynamics is not None:
                obs.dynamics.record_round(round_idx, state, kept, new_state,
                                          engine="round")
            state = new_state
        return state, comm, down

    def run(self, *, initial_state=None,
            batch_fn: Optional[Callable[[int], list]] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 5) -> Tuple[object, List[RoundRecord]]:
        """Run ``sim.rounds`` rounds, evaluating every ``eval_every``
        rounds and on the last.  ``initial_state`` skips ``init_state``
        but not the strategy's ``setup``.  Returns (final_state, history)
        with one record per eval checkpoint.

        With ``resume=`` set and a usable checkpoint present, the run
        continues from it: server state (on the context's device), rng
        stream, channel state, validator calibration and the history so
        far restore to the checkpointed round's, and the loop picks up at
        the next round, reproducing the uninterrupted run bitwise.

        With a ``history_sink`` each record streams to the sink as it is
        produced and the returned history stays EMPTY."""
        ctx = self.ctx
        setup = getattr(self.strategy, "setup", None)
        if setup is not None:
            setup(ctx)
        resumed = load_resume(self._resume_dir, ctx.device) \
            if self._resume_dir is not None else None
        history: List[RoundRecord] = []
        start_rd, bytes_acc, down_acc = 0, 0, 0
        if resumed is not None:
            rd0, state, aux = resumed
            start_rd = rd0 + 1
            bytes_acc = int(aux.get("bytes_acc", 0))
            down_acc = int(aux.get("down_acc", 0))
            if self.history_sink is None:
                history = [RoundRecord(*r) for r in aux.get("history", [])]
            self._import_aux(aux)
        else:
            state = initial_state if initial_state is not None \
                else self.strategy.init_state(ctx)
        batch_fn = batch_fn or self.default_batch_fn()
        t_last = time.perf_counter()
        try:
            with scope(self.obs):
                for rd in range(start_rd, ctx.sim.rounds):
                    state, comm, down = self.run_round(state, rd, batch_fn)
                    bytes_acc += comm
                    down_acc += down
                    if (rd + 1) % eval_every == 0 \
                            or rd == ctx.sim.rounds - 1:
                        with span_if(self.obs, "eval", round=rd + 1):
                            acc = eval_state(self.strategy, ctx, state,
                                             eval_fn)
                        if ctx.device.type == "cuda":
                            torch.cuda.synchronize(ctx.device)
                        now = time.perf_counter()
                        rec = RoundRecord(rd + 1, acc, now - t_last,
                                          bytes_acc, 0.0, down_acc)
                        if self.history_sink is not None:
                            self.history_sink.write(rec)
                        else:
                            history.append(rec)
                        t_last, bytes_acc, down_acc = now, 0, 0
                    if self._ckpt is not None and self._ckpt.due(rd):
                        self._ckpt.save(rd, state, self._export_aux(
                            history, bytes_acc, down_acc))
        finally:
            close_history_sink(self.history_sink, self._owns_sink)
        return state, history

    # ----------------------------------------------- checkpoint / resume
    def _export_aux(self, history, bytes_acc: int, down_acc: int) -> dict:
        """Everything bitwise continuation needs beyond the server state:
        the shared rng stream, the channel's EF residuals and downlink
        tracker, the validator's norm calibration, and the history so
        far."""
        return {
            "kind": "round",
            "rng": self.ctx.rng.bit_generator.state,
            "channel": self.channel.export_state(),
            "faultrt": self._faultrt.export_state(),
            "history": [list(r) for r in history]
            if self.history_sink is None else [],
            "bytes_acc": int(bytes_acc), "down_acc": int(down_acc),
        }

    def _import_aux(self, aux: dict) -> None:
        self.ctx.rng.bit_generator.state = aux["rng"]
        self.channel.import_state(aux.get("channel") or {})
        if aux.get("faultrt"):
            self._faultrt.import_state(aux["faultrt"])

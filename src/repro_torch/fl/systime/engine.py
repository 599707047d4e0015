"""`AsyncEngine` — system-time simulation over the strategy protocol
(port of ``repro.fl.systime.engine``).

Two execution semantics over one virtual clock
(:class:`repro_torch.fl.systime.clock.EventLoop`):

* ``mode="sync"`` — barrier rounds like :class:`repro_torch.fl.engine
  .RoundEngine`, but every client-round is priced by the
  :class:`~repro_torch.fl.systime.profiles.SystemModel` and the round
  advances the clock by the slowest participant.  With ``deadline_s``
  set, a client whose download + compute + upload exceeds the deadline
  MISSES the round (its update is discarded, its bytes never count).
  With a zero-latency system and no deadline this path reproduces
  ``RoundEngine`` exactly: same samplers, same scheduler, same rng
  stream, same aggregation.

* ``mode="async"`` — FedBuff-style buffered asynchrony: up to
  ``concurrency`` clients train concurrently, each on a snapshot of the
  server state; finish events pop in virtual-time order; once
  ``buffer_size`` results accumulate the server merges them via the
  strategy's ``aggregate_async`` (staleness-weighted; see
  :mod:`repro_torch.fl.systime.staleness`) and bumps its version.
  ``round`` in the history = server version; ``sim.rounds`` = number of
  server updates.

A client in async mode trains eagerly on the state it was dispatched
with; its result (encoded against that snapshot) is parked in the event
heap until its finish event.  No port path writes a tensor of the server
state or of a parked result in place, so a later merge never reaches
into a parked snapshot.

Every record carries ``sim_seconds`` (absolute virtual time); the engine
also keeps a ``trace`` of (kind, time, client, version, staleness)
tuples, which equals the reference engine's for the same seed.  The
engine runs on the context's device.  ``history_sink`` streams the
records and the trace to a JSONL file instead of the two lists;
``state_store`` (a ``repro_torch.fl.scale`` ClientStateStore) parks the
async in-flight snapshots, so a bounded ``SpillStore`` keeps at most its
capacity resident; ``obs`` records the scheduling events as typed
``SysEvent``s (the ``trace`` list is their legacy projection, tuple for
tuple) beside spans and metrics.
"""
from __future__ import annotations

import heapq
import time
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.fl.comm import CommChannel
from repro_torch.fl.engine import (RoundRecord, apply_prefix_cache,
                                   close_history_sink, default_batch_fn,
                                   eval_state, load_resume,
                                   resolve_checkpointing, resolve_faults,
                                   resolve_history_sink)
from repro_torch.fl.sampling import CohortSampler, UniformSampler, \
    make_scheduler
from repro_torch.fl.strategy import ClientResult, Context, FLStrategy, \
    wire_bytes
from repro_torch.fl.systime.availability import AvailabilityModel
from repro_torch.fl.systime.clock import Event, EventLoop
from repro_torch.fl.systime.profiles import SystemModel, zero_latency_system
from repro_torch.fl.systime.staleness import default_aggregate_async
from repro_torch.obs import make_obs, scope, span_if

#: Staleness is measured in whole server versions — integer buckets.
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class AsyncEngine:
    """Event-driven FL engine: a strict superset of ``RoundEngine``
    (sync mode + zero latency degenerates to it)."""

    def __init__(self, strategy: FLStrategy, ctx: Context, *,
                 system: Optional[SystemModel] = None,
                 sampler: Optional[CohortSampler] = None,
                 scheduler=None,
                 availability: Optional[AvailabilityModel] = None,
                 mode: str = "async",
                 concurrency: Optional[int] = None,
                 buffer_size: Optional[int] = None,
                 staleness_alpha: float = 0.5,
                 deadline_s: Optional[float] = None,
                 prefix_cache: str = "on",
                 codec="none", downlink: str = "full",
                 channel: Optional[CommChannel] = None,
                 history_sink=None, state_store=None, obs=None,
                 faults=None, resilience=None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_keep: int = 3,
                 resume: Union[bool, str, None] = None):
        """The knobs as on the reference: ``system`` (zero latency by
        default), ``sampler`` / ``availability`` (sync mode), ``mode``,
        ``concurrency`` / ``buffer_size`` / ``staleness_alpha`` (async
        mode), ``deadline_s`` (sync mode), the wire (``codec`` /
        ``downlink`` / ``channel``, priced in both link directions from
        the encoded bytes), ``faults`` / ``resilience`` and the
        checkpoint / resume knobs (as on ``RoundEngine``; an async
        checkpoint carries the live event heap), ``history_sink`` and
        ``obs`` (as on ``RoundEngine``; the sink also receives the trace),
        and ``state_store``, where async mode parks each in-flight
        snapshot under ``("inflight", client, seq)``."""
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        self.strategy = strategy
        self.ctx = apply_prefix_cache(ctx, prefix_cache)
        self.channel = channel or CommChannel(codec, downlink)
        self.system = system or zero_latency_system(ctx.num_clients)
        if len(self.system.profiles) != ctx.num_clients:
            raise ValueError(
                f"system has {len(self.system.profiles)} profiles for "
                f"{ctx.num_clients} clients")
        self.sampler = sampler or UniformSampler()
        self.scheduler = make_scheduler(scheduler)
        self.availability = availability
        self.mode = mode
        if mode == "async" and deadline_s is not None:
            raise ValueError("deadline_s is a sync-mode knob (async has no "
                             "barrier to miss); drop it or use mode='sync'")
        if sampler is not None and (mode == "async"
                                    or availability is not None):
            raise ValueError(
                "a cohort sampler only applies to mode='sync' without an "
                "availability model (async dispatches one client at a time "
                "from the available pool; availability replaces the "
                "sampler's population)")
        if mode == "sync" and (concurrency is not None
                               or buffer_size is not None):
            raise ValueError("concurrency/buffer_size only apply to "
                             "mode='async'; sync rounds use the sampler's "
                             "cohort size")
        cohort = max(1, int(np.ceil(ctx.sim.participation
                                    * ctx.num_clients)))
        self.concurrency = concurrency or cohort
        self.buffer_size = buffer_size or max(1, self.concurrency // 2)
        self.staleness_alpha = float(staleness_alpha)
        self.deadline_s = deadline_s
        self.clock = EventLoop()
        # fault decisions key on (round | version, client, attempt), so
        # the same plan reproduces across engines, modes and resumes
        self._faultrt = resolve_faults(faults, resilience)
        self._ckpt, self._resume_dir = resolve_checkpointing(
            checkpoint_every, checkpoint_dir, checkpoint_keep, resume)
        self.history_sink, self._owns_sink = resolve_history_sink(
            history_sink, mode="a" if self._resume_dir else "w")
        self.state_store = state_store
        self._inflight_seq = 0
        self._merging = 0
        self.trace: List[tuple] = []
        # the legacy trace list becomes the projection of the typed
        # SysEvents; the tracer's sim clock is this engine's virtual clock
        self.obs = make_obs(obs)
        if self.obs is not None:
            if self.obs.tracer.sim_clock is None:
                self.obs.tracer.sim_clock = lambda: self.clock.now
            self.obs.bind(self.ctx)

    def _trace(self, kind: str, t: float, client: int, version: int,
               extra, attrs=None) -> None:
        """Record one scheduling event.  The legacy tuple lands in
        ``self.trace`` (or the sink); with telemetry on it is the
        projection of the typed event just recorded (``attrs`` — the
        per-phase latency split — ride only on the typed side)."""
        if self.obs is not None:
            event = self.obs.tracer.sys(kind, t, client, version, extra,
                                        attrs=attrs).legacy()
        else:
            event = (kind, t, client, version, extra)
        if self.history_sink is not None \
                and hasattr(self.history_sink, "write_trace"):
            self.history_sink.write_trace(event)
        else:
            self.trace.append(event)

    def _phase_attrs(self, client: int, lat) -> dict:
        """The Chrome-trace lane payload of one in-flight interval: start
        time, the latency model's three phase durations and the client's
        device tier (built only with telemetry on)."""
        return {"start": float(self.clock.now),
                "tier": self.system.profiles[client].name,
                "download": float(lat.download),
                "compute": float(lat.compute),
                "upload": float(lat.upload)}

    def _record(self, history: List[RoundRecord], rec: RoundRecord) -> None:
        if self.history_sink is not None:
            self.history_sink.write(rec)
        else:
            history.append(rec)

    def _count_miss(self, k: int) -> None:
        if self.obs is not None:
            self.obs.metrics.counter(
                "deadline_misses", tier=self.system.profiles[k].name).inc()

    def _reject(self, rnd: int, k: int, verdict, engine: str) -> None:
        """A quarantine's bookkeeping beyond the trace: the validator's
        counter and the dynamics timeline."""
        self._faultrt.record_quarantine(k, verdict)
        if self.obs is not None and self.obs.dynamics is not None:
            self.obs.dynamics.record_rejection(rnd, k, verdict.reason,
                                               engine=engine)

    # ------------------------------------------------------------- helpers
    def default_batch_fn(self) -> Callable[[int], list]:
        """The same per-round local loader as ``RoundEngine``."""
        return default_batch_fn(self.ctx)

    def _latency(self, client_id: int, result: ClientResult,
                 n_batches: int, download_bytes: int):
        # the encoded uplink when a channel ran; wire_bytes is the
        # fallback for strategies that left comm_bytes unset
        up = result.comm_bytes if result.comm_bytes is not None \
            else wire_bytes(result.payload)
        # strategies that do not train the client's FeDepth decomposition
        # declare their actual compute through the client_work hook
        client_work = getattr(self.strategy, "client_work", None)
        work = client_work(self.ctx, client_id) if client_work else None
        # a depth-wise strategy's runner says which buffered-prefix
        # schedule to price
        runner = getattr(self.strategy, "runner", None)
        stable = getattr(runner, "prefix_stable", None)
        return self.system.latency(self.ctx, client_id, upload_bytes=up,
                                   download_bytes=download_bytes,
                                   n_batches=n_batches, work=work,
                                   prefix_stable=stable), up

    def _eval(self, state, eval_fn):
        acc = eval_state(self.strategy, self.ctx, state, eval_fn)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        return acc

    def _apply_async(self, state, buffered):
        """Merge one buffer into the next server state (the version it
        makes is ``self._merging``, for the dynamics timeline)."""
        # results travel encoded and decode only here, at the merge
        results = [self.channel.decode_result(r) for r, _ in buffered]
        stale = [s for _, s in buffered]
        agg = getattr(self.strategy, "aggregate_async", None)
        if agg is not None:
            new_state = agg(self.ctx, state, results, stale,
                            alpha=self.staleness_alpha)
        else:
            new_state = default_aggregate_async(
                self.strategy, self.ctx, state, results, stale,
                alpha=self.staleness_alpha)
        if self.obs is not None and self.obs.dynamics is not None:
            self.obs.dynamics.record_round(
                self._merging, state, results, new_state, staleness=stale,
                alpha=self.staleness_alpha, engine="systime-async")
        return new_state

    # ------------------------------------------------------------------ run
    def run(self, *, initial_state=None,
            batch_fn: Optional[Callable[[int], list]] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 5) -> Tuple[object, List[RoundRecord]]:
        """History contract of ``RoundEngine.run`` (one record per eval
        checkpoint, never fewer), with ``sim_seconds`` stamped from the
        virtual clock.  With ``resume=`` set and a usable checkpoint
        present the run continues from it bitwise — server state, rng,
        channel, virtual clock, trace and (async mode) the in-flight event
        heap all restore, every tensor on the context's device."""
        ctx = self.ctx
        setup = getattr(self.strategy, "setup", None)
        if setup is not None:
            setup(ctx)
        resumed = load_resume(self._resume_dir, ctx.device) \
            if self._resume_dir is not None else None
        if resumed is not None:
            rd0, state, aux = resumed
            self.ctx.rng.bit_generator.state = aux["rng"]
            self.channel.import_state(aux.get("channel") or {})
            if aux.get("faultrt"):
                self._faultrt.import_state(aux["faultrt"])
            resume_at = (rd0, aux)
        else:
            state = initial_state if initial_state is not None \
                else self.strategy.init_state(ctx)
            resume_at = None
        batch_fn = batch_fn or self.default_batch_fn()
        if self.obs is not None:
            # (re)bind in case one Obs is shared across engines: the
            # RUNNING engine's virtual clock stamps sim time
            self.obs.tracer.sim_clock = lambda: self.clock.now
        try:
            with scope(self.obs):
                if self.mode == "sync":
                    return self._run_sync(state, batch_fn, eval_fn,
                                          eval_every, resume_at)
                return self._run_async(state, batch_fn, eval_fn,
                                       eval_every, resume_at)
        finally:
            close_history_sink(self.history_sink, self._owns_sink)

    # ------------------------------------------------------------- sync mode
    def _sample_cohort(self, round_idx: int) -> np.ndarray:
        if self.availability is None:
            return self.sampler.sample(self.ctx, round_idx)
        avail = np.asarray(self.availability.available(self.ctx,
                                                       self.clock.now))
        k = max(1, int(np.ceil(self.ctx.sim.participation
                               * self.ctx.num_clients)))
        k = min(k, len(avail))
        return self.ctx.rng.choice(avail, size=k, replace=False)

    def _run_sync(self, state, batch_fn, eval_fn, eval_every,
                  resume_at=None):
        ctx, chan, rt = self.ctx, self.channel, self._faultrt
        history: List[RoundRecord] = []
        t_last, bytes_acc, down_acc = time.perf_counter(), 0, 0
        start_rd = 0
        if resume_at is not None:
            rd0, aux = resume_at
            start_rd = rd0 + 1
            bytes_acc = int(aux.get("bytes_acc", 0))
            down_acc = int(aux.get("down_acc", 0))
            self.clock.now = float(aux.get("clock_now", 0.0))
            if self.history_sink is None:
                history = [RoundRecord(*r) for r in aux.get("history", [])]
                self.trace = [tuple(e) for e in aux.get("trace", [])]
        for rd in range(start_rd, ctx.sim.rounds):
            round_span = None if self.obs is None else \
                self.obs.tracer.begin("round", round=rd,
                                      engine="systime-sync")
            cohort = rt.overprovision(
                ctx, [int(k) for k in self._sample_cohort(rd)])
            # broadcast: each client's downlink on the wire — even a
            # later deadline-misser pays for its download
            downs = {k: chan.downlink_bytes(self.strategy, ctx, state, k)
                     for k in cohort}
            down_acc += sum(downs.values())
            # count what the loader actually produced per client (a
            # custom batch_fn need not follow the |D_k| / B formula)
            n_drawn: dict = {}

            def counting_batch_fn(k, _fn=batch_fn, _n=n_drawn):
                batches = _fn(k)
                _n[k] = len(batches)
                return batches
            kept, totals = [], []
            if not rt.enabled:
                results = self.scheduler.run(ctx, self.strategy, state,
                                             cohort, counting_batch_fn)
                for k, res in zip(cohort, results):
                    res.client_id = k
                    # delivery can still fail at the deadline: snapshot
                    # the error-feedback residual so that a discarded
                    # payload's transmitted mass is not dropped from it
                    ef_snap = chan.snapshot_uplink(k)
                    res = chan.encode_result(self.strategy, ctx, state,
                                             k, res)
                    lat, up = self._latency(k, res, n_drawn.get(k, 1),
                                            downs[k])
                    attrs = None if self.obs is None \
                        else self._phase_attrs(k, lat)
                    if self.deadline_s is not None \
                            and lat.total > self.deadline_s:
                        chan.rollback_uplink(k, ef_snap)
                        # the miss is observed when the server gives up
                        self._trace("miss",
                                    float(self.clock.now
                                          + self.deadline_s),
                                    k, rd, round(float(lat.total), 9),
                                    attrs=attrs)
                        self._count_miss(k)
                        continue
                    kept.append(chan.decode_result(res))
                    totals.append(lat.total)
                    bytes_acc += up
                    # the client's virtual completion time, as async
                    # mode stamps its finish events
                    self._trace("finish",
                                float(self.clock.now + lat.total), k,
                                rd, round(float(lat.total), 9),
                                attrs=attrs)
                round_time = max(totals) if totals else 0.0
                if self.deadline_s is not None \
                        and len(kept) < len(cohort):
                    round_time = self.deadline_s   # wait out the deadline
            else:
                n_failed, bts = self._sync_wave(rd, cohort, state, downs,
                                                counting_batch_fn,
                                                n_drawn, kept, totals)
                bytes_acc += bts
                round_time = max(totals) if totals else 0.0
                if n_failed > 0:
                    rt.record_shortfall(n_failed)
                    extra = [int(k) for k in
                             rt.resample(ctx, cohort, n_failed)]
                    if extra:
                        # one replacement wave, sequenced after the
                        # failures are known: its slowest client adds to
                        # the barrier on top of the first wave
                        downs2 = {k: chan.downlink_bytes(
                            self.strategy, ctx, state, k) for k in extra}
                        down_acc += sum(downs2.values())
                        totals2: List[float] = []
                        _, bts2 = self._sync_wave(rd, extra, state,
                                                  downs2,
                                                  counting_batch_fn,
                                                  n_drawn, kept, totals2)
                        bytes_acc += bts2
                        round_time += max(totals2) if totals2 else 0.0
                if self.deadline_s is not None:
                    round_time = min(round_time, self.deadline_s)
            self.clock.advance(round_time)
            if kept:
                new_state = self.strategy.aggregate(ctx, state, kept)
                if self.obs is not None and self.obs.dynamics is not None:
                    self.obs.dynamics.record_round(
                        rd, state, kept, new_state, engine="systime-sync")
                state = new_state
            self._trace("aggregate", float(self.clock.now), -1, rd,
                        len(kept))
            if round_span is not None:
                self.obs.tracer.end(round_span, cohort=len(cohort),
                                    merged=len(kept))
            if (rd + 1) % eval_every == 0 or rd == ctx.sim.rounds - 1:
                with span_if(self.obs, "eval", round=rd + 1):
                    acc = self._eval(state, eval_fn)
                now = time.perf_counter()
                self._record(history, RoundRecord(rd + 1, acc, now - t_last,
                                                  bytes_acc, self.clock.now,
                                                  down_acc))
                t_last, bytes_acc, down_acc = now, 0, 0
            if self._ckpt is not None and self._ckpt.due(rd):
                # traced BEFORE the aux export, so that the saved trace
                # holds it and a resumed run reproduces the whole trace
                self._trace("checkpoint", float(self.clock.now), -1,
                            rd, rd)
                self._ckpt.save(rd, state, self._export_aux_sync(
                    history, bytes_acc, down_acc))
        return state, history

    def _sync_wave(self, rd: int, clients, state, downs, batch_fn,
                   n_drawn, kept, times) -> Tuple[int, int]:
        """One fault-aware sync wave over ``clients``.  Appends the
        surviving decoded results to ``kept`` and each client's
        completion time (retries, backoff and slowdowns priced in) to
        ``times``; returns ``(n_failed, uplink_bytes)``, ``n_failed``
        counting the clients lost for good (retries exhausted or
        deadline missed) — the shortfall the degradation policy may
        resample.  A quarantined client finished on time, so it extends
        the barrier and its garbage bytes count, but its update never
        reaches the aggregate and its EF residual rolls back."""
        ctx, chan, rt = self.ctx, self.channel, self._faultrt
        results = self.scheduler.run(ctx, self.strategy, state, clients,
                                     batch_fn)
        n_failed, bts = 0, 0
        for k, res in zip(clients, results):
            res.client_id = k
            outcome = rt.resolve(
                rd, k, res,
                lambda k=k: self.strategy.client_update(ctx, state, k,
                                                        batch_fn(k)))
            if not outcome.delivered:
                lat, _ = self._latency(k, res, n_drawn.get(k, 1),
                                       downs[k])
                t_fail = float(outcome.total_seconds(lat))
                times.append(t_fail)
                n_failed += 1
                self._trace("fail", float(self.clock.now + t_fail), k,
                            rd, "|".join(outcome.kinds))
                continue
            ef_snap = chan.snapshot_uplink(k)
            enc = chan.encode_result(self.strategy, ctx, state, k,
                                     outcome.result)
            lat, up = self._latency(k, enc, n_drawn.get(k, 1), downs[k])
            total = float(outcome.total_seconds(lat))
            attrs = None if self.obs is None else self._phase_attrs(k, lat)
            if self.deadline_s is not None and total > self.deadline_s:
                chan.rollback_uplink(k, ef_snap)
                self._trace("miss",
                            float(self.clock.now + self.deadline_s), k,
                            rd, round(total, 9), attrs=attrs)
                self._count_miss(k)
                # the server only learns of the miss at the deadline, so
                # the barrier waits it out
                times.append(float(self.deadline_s))
                n_failed += 1
                continue
            dec = chan.decode_result(enc)
            verdict = rt.validate_one(dec.payload, state)
            if verdict is not None:
                chan.rollback_uplink(k, ef_snap)
                self._reject(rd, k, verdict, "systime-sync")
                bts += up
                times.append(total)
                self._trace("quarantine", float(self.clock.now + total),
                            k, rd, verdict.reason, attrs=attrs)
                continue
            kept.append(dec)
            times.append(total)
            bts += up
            self._trace("finish", float(self.clock.now + total), k, rd,
                        round(total, 9), attrs=attrs)
        return n_failed, bts

    # ----------------------------------------------- checkpoint / resume
    def _aux_common(self, history, bytes_acc: int, down_acc: int) -> dict:
        return {
            "rng": self.ctx.rng.bit_generator.state,
            "channel": self.channel.export_state(),
            "faultrt": self._faultrt.export_state(),
            "history": [list(r) for r in history]
            if self.history_sink is None else [],
            "trace": [list(e) for e in self.trace]
            if self.history_sink is None else [],
            "bytes_acc": int(bytes_acc), "down_acc": int(down_acc),
        }

    def _export_aux_sync(self, history, bytes_acc, down_acc) -> dict:
        aux = self._aux_common(history, bytes_acc, down_acc)
        aux.update(kind="systime-sync", clock_now=float(self.clock.now))
        return aux

    def _export_aux_async(self, history, bytes_acc, version,
                          running) -> dict:
        """Async checkpoints also carry the live event loop — clock time,
        tie-break sequence, and every scheduled finish / fail event WITH
        its in-flight payload.  Taken only at buffer-empty points, so the
        merge buffer never needs to travel.  Snapshots parked in a
        ``state_store`` are materialized into the blob as ``("__parked__",
        key, value)`` and re-parked on resume.  An in-flight payload is
        pickled: a lossy codec's ``WireUpdate`` whose strategy attaches a
        rebuild closure (HeteroFL, DepthFL, SplitMix, masked FeDepth) is
        not picklable, so checkpoint async runs of those under
        ``codec="none"``, as on the reference."""
        aux = self._aux_common(history, bytes_acc, 0)
        events = []
        for e in sorted(self.clock._heap):
            p = e.payload
            if self._parked(p):
                p = ("__parked__", p, self.state_store.get(p))
            events.append((float(e.time), int(e.seq), e.kind,
                           int(e.client), p))
        aux.update(kind="systime-async",
                   clock_now=float(self.clock.now),
                   clock_seq=int(self.clock._seq),
                   events=events,
                   running=sorted(int(k) for k in running),
                   version=int(version),
                   down_acc=int(self._down_acc),
                   inflight_seq=int(self._inflight_seq))
        return aux

    def _parked(self, payload) -> bool:
        """Whether an event's payload is a ``state_store`` key."""
        return self.state_store is not None and isinstance(payload, tuple) \
            and len(payload) == 3 and payload[0] == "inflight"

    def _import_clock_async(self, aux) -> None:
        self.clock = EventLoop()
        self.clock.now = float(aux["clock_now"])
        self.clock._seq = int(aux["clock_seq"])
        heap = []
        for t, seq, kind, client, p in aux["events"]:
            if isinstance(p, tuple) and p and p[0] == "__parked__":
                _, key, value = p
                key = tuple(key)
                if self.state_store is not None:
                    self.state_store[key] = value
                    p = key
                else:
                    p = value          # resumed without a store: inline
            heap.append(Event(float(t), int(seq), str(kind), int(client),
                              p))
        heapq.heapify(heap)
        self.clock._heap = heap
        if self.obs is not None:
            self.obs.tracer.sim_clock = lambda: self.clock.now

    # ------------------------------------------------------------ async mode
    def _free_clients(self, running, *, ignore_availability=False):
        if self.availability is None or ignore_availability:
            avail = np.arange(self.ctx.num_clients)
        else:
            avail = np.asarray(self.availability.available(self.ctx,
                                                           self.clock.now))
        return np.setdiff1d(avail, np.asarray(sorted(running), np.int64))

    def _dispatch(self, state, version, running, batch_fn, *,
                  force: bool = False) -> bool:
        """Start one idle AVAILABLE client.  With nobody available the
        dispatch is skipped (in-flight work will advance the clock and
        availability with it) — unless ``force``, the deadlock escape the
        run loop uses when NOTHING is in flight; forced dispatches are
        marked in the trace."""
        free = self._free_clients(running)
        forced = False
        if free.size == 0:
            if not force:
                return False
            free = self._free_clients(running, ignore_availability=True)
            forced = True
            if free.size == 0:
                return False
        k = int(self.ctx.rng.choice(free))
        down = self.channel.downlink_bytes(self.strategy, self.ctx, state, k)
        self._down_acc += down
        batches = batch_fn(k)
        # the client trains on the CURRENT state — an eager snapshot; the
        # result just doesn't merge until its finish event fires
        with span_if(self.obs, "client-update", client=k, version=version):
            res = self.strategy.client_update(self.ctx, state, k, batches)
        res.client_id = k
        rt = self._faultrt
        if not rt.enabled:
            # encode against the snapshot: the WireUpdate carries that
            # very reference, so the server decodes correctly however
            # many versions land before this result does
            res = self.channel.encode_result(self.strategy, self.ctx,
                                             state, k, res)
            lat, up = self._latency(k, res, len(batches), down)
            total = lat.total
            payload = (res, version, up)
        else:
            # fault resolution keys on the dispatch-time server version
            # (the async notion of a round); a lost dispatch still
            # occupies the client until its failure time, then frees it
            # through a "__fail__" event
            outcome = rt.resolve(
                version, k, res,
                lambda: self.strategy.client_update(self.ctx, state, k,
                                                    batch_fn(k)))
            if outcome.delivered:
                ef_snap = self.channel.snapshot_uplink(k)
                enc = self.channel.encode_result(self.strategy, self.ctx,
                                                 state, k, outcome.result)
                lat, up = self._latency(k, enc, len(batches), down)
                total = float(outcome.total_seconds(lat))
                payload = ("__ok__", enc, version, up, ef_snap)
            else:
                lat, _ = self._latency(k, res, len(batches), down)
                total = float(outcome.total_seconds(lat))
                payload = ("__fail__", "|".join(outcome.kinds))
        running.add(k)
        if self.state_store is not None:
            # park the in-flight snapshot in the store (a bounded
            # SpillStore keeps at most its capacity resident); the clock
            # event carries only the key
            key = ("inflight", k, self._inflight_seq)
            self._inflight_seq += 1
            self.state_store[key] = payload
            payload = key
        self.clock.schedule(total, "finish", client=k, payload=payload)
        self._trace("dispatch_forced" if forced else "dispatch",
                    float(self.clock.now), k, version,
                    round(float(total), 9),
                    attrs=None if self.obs is None
                    else self._phase_attrs(k, lat))
        return True

    def _run_async(self, state, batch_fn, eval_fn, eval_every,
                   resume_at=None):
        ctx, rt = self.ctx, self._faultrt
        history: List[RoundRecord] = []
        version = 0
        running: set = set()
        buffered: List[tuple] = []
        t_last, bytes_acc = time.perf_counter(), 0
        self._down_acc = 0              # the downlink accrues at dispatch
        if resume_at is not None:
            # re-enter at the top of the loop: checkpoints are taken at
            # buffer-empty points, so only the event heap (with its
            # in-flight payloads), the running set and the accumulators
            # come back
            _, aux = resume_at
            version = int(aux["version"])
            running = set(int(k) for k in aux["running"])
            bytes_acc = int(aux.get("bytes_acc", 0))
            self._down_acc = int(aux.get("down_acc", 0))
            self._inflight_seq = int(aux.get("inflight_seq", 0))
            self._import_clock_async(aux)
            if self.history_sink is None:
                history = [RoundRecord(*r) for r in aux.get("history", [])]
                self.trace = [tuple(e) for e in aux.get("trace", [])]
        else:
            for _ in range(self.concurrency):
                self._dispatch(state, version, running, batch_fn)
            if not running:   # nobody reachable at t=0: force one start
                self._dispatch(state, version, running, batch_fn,
                               force=True)
        while version < ctx.sim.rounds and len(self.clock):
            ev = self.clock.pop()
            payload = ev.payload
            if self._parked(payload):
                payload = self.state_store.pop(payload)
            running.discard(ev.client)
            did_agg = False
            dropped = False
            if rt.enabled and payload[0] == "__fail__":
                # the dispatch was lost for good (retries exhausted): the
                # client frees up, nothing merges
                dropped = True
                self._trace("fail", float(self.clock.now), ev.client,
                            version, payload[1])
            elif rt.enabled:
                _, res, v0, up, ef_snap = payload
            else:
                res, v0, up = payload
            if not dropped:
                staleness = version - v0
                if rt.enabled:
                    # quarantine at the merge boundary, against the
                    # CURRENT server state; rejected mass rolls the EF
                    # residual back to its dispatch-time snapshot
                    res = self.channel.decode_result(res)
                    verdict = rt.validate_one(res.payload, state)
                    if verdict is not None:
                        self.channel.rollback_uplink(ev.client, ef_snap)
                        self._reject(version, ev.client, verdict,
                                     "systime-async")
                        bytes_acc += up     # garbage still crossed the wire
                        dropped = True
                        self._trace("quarantine", float(self.clock.now),
                                    ev.client, version, verdict.reason)
            if not dropped:
                buffered.append((res, staleness))
                bytes_acc += up
                self._trace("finish", float(self.clock.now), ev.client,
                            version, staleness)
                if self.obs is not None:
                    self.obs.metrics.histogram(
                        "staleness", buckets=STALENESS_BUCKETS,
                        tier=self.system.profiles[ev.client].name,
                    ).observe(staleness)
                if len(buffered) >= self.buffer_size:
                    self._merging = version + 1
                    with span_if(self.obs, "aggregate", version=version + 1,
                                 merged=len(buffered)):
                        state = self._apply_async(state, buffered)
                    version += 1
                    did_agg = True
                    self._trace("aggregate", float(self.clock.now), -1,
                                version, len(buffered))
                    buffered = []
                    if version % eval_every == 0 \
                            or version == ctx.sim.rounds:
                        acc = self._eval(state, eval_fn)
                        now = time.perf_counter()
                        self._record(history, RoundRecord(
                            version, acc, now - t_last, bytes_acc,
                            self.clock.now, self._down_acc))
                        t_last, bytes_acc = now, 0
                        self._down_acc = 0
            if version < ctx.sim.rounds:
                self._dispatch(state, version, running, batch_fn)
                if not running and not len(self.clock):
                    # nothing in flight and no pending events: the clock
                    # can only advance through work — force a dispatch
                    self._dispatch(state, version, running, batch_fn,
                                   force=True)
            if did_agg and self._ckpt is not None \
                    and self._ckpt.due(version - 1):
                # after the post-aggregate dispatches, at a buffer-empty
                # point; traced before the aux export (bitwise resume)
                self._trace("checkpoint", float(self.clock.now), -1,
                            version, version - 1)
                self._ckpt.save(version - 1, state, self._export_aux_async(
                    history, bytes_acc, version, running))
        if not history or history[-1].round != version:
            acc = self._eval(state, eval_fn)
            now = time.perf_counter()
            self._record(history, RoundRecord(version, acc, now - t_last,
                                              bytes_acc, self.clock.now,
                                              self._down_acc))
            self._down_acc = 0
        return state, history

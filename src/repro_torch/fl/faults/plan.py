"""Deterministic, seeded fault model over client dispatches (port of
``repro.fl.faults.plan``).

The paper's premise is a fleet of unreliable heterogeneous devices, yet
the engines historically assumed every sampled client either finishes
cleanly or misses a deadline.  :class:`FaultPlan` closes that gap with a
controlled fault model: each *dispatch attempt* — identified by
``(round_or_version, client_id, attempt)`` — draws its fate from an rng
derived ONLY from that identity plus the plan seed, so fault sequences
are reproducible per seed, independent of execution order, and identical
across engines (the property the deterministic benchmarks and the
kill-and-resume tests rely on).

Fault taxonomy:

``crash``
    The client dies at block k of its depth-wise update: a fraction
    ``frac`` of the local compute was spent, nothing is uploaded.
    Transient — a retry re-runs the whole local update.
``drop``
    The uplink payload is lost in transit (flaky link): full compute and
    a full upload were spent, nothing arrives.  Transient.
``corrupt``
    The uplink payload arrives BIT-CORRUPTED: a seeded subset of
    float32 coordinates has its mantissa scrambled and exponent pinned
    high — FINITE garbage of magnitude ~1e38, so a plain non-finite
    check does not catch it.  Permanent for the attempt — the server
    must quarantine it (:mod:`repro_torch.fl.faults.quarantine`).
``diverge``
    The client's training diverged: a random subset of coordinates is
    NaN.  Permanent for the attempt; caught by the non-finite
    quarantine guard (and, as a last line, by
    ``core.aggregation``'s default non-finite guard).
``slowdown``
    Transient device slowdown (thermal throttling, contention): the
    attempt succeeds but its compute is ``factor`` times slower — priced
    in sim seconds by the systime engines, a no-op for the wall-clock
    ``RoundEngine``.

Rates are per-attempt probabilities and must sum to <= 1; the remaining
mass is a clean attempt.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.fl.comm.codecs import _is_float_array, flatten
from repro_torch.layout import to_stacked_layout
from repro_torch.obs import active as obs_active
from repro_torch.tree import tree_map

FAULT_KINDS = ("crash", "drop", "corrupt", "diverge", "slowdown")

#: Transient faults: the update is lost but a retry can recover it.
TRANSIENT_KINDS = ("crash", "drop")

#: Payload faults: the update arrives damaged; only quarantine helps.
PAYLOAD_KINDS = ("corrupt", "diverge")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault decision for one dispatch attempt."""
    kind: str                    # one of FAULT_KINDS
    client: int
    round: int                   # round (sync) or server version (async)
    attempt: int
    frac: float = 1.0            # crash: fraction of compute spent
    factor: float = 1.0          # slowdown: compute multiplier


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded per-attempt fault rates.  ``seed`` is independent of the
    simulation seed so the same training run can be replayed under
    different fault draws (and vice versa)."""
    seed: int = 0
    crash_rate: float = 0.0
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    diverge_rate: float = 0.0
    slowdown_rate: float = 0.0
    slowdown_factor: float = 4.0   # compute multiplier for slowdown faults
    corrupt_frac: float = 1e-3     # fraction of coordinates hit per leaf

    def __post_init__(self):
        rates = (self.crash_rate, self.drop_rate, self.corrupt_rate,
                 self.diverge_rate, self.slowdown_rate)
        if any(r < 0 for r in rates) or sum(rates) > 1.0 + 1e-9:
            raise ValueError(
                f"fault rates must be >= 0 and sum to <= 1, got {rates}")

    @property
    def total_rate(self) -> float:
        return (self.crash_rate + self.drop_rate + self.corrupt_rate
                + self.diverge_rate + self.slowdown_rate)


class FaultInjector:
    """Applies a :class:`FaultPlan`: decides each attempt's fate and
    performs the payload damage for ``corrupt``/``diverge`` faults.

    Decisions are pure functions of ``(plan.seed, round, client,
    attempt)`` via :class:`numpy.random.SeedSequence` — no hidden
    counter, so two engines (or a resumed run) replaying the same
    dispatch identities draw the same faults.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    # ------------------------------------------------------------- decide
    def _rng(self, *entropy: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.plan.seed,) + tuple(
                int(e) & 0x7FFFFFFF for e in entropy)))

    def decide(self, round_idx: int, client_id: int,
               attempt: int) -> Optional[Fault]:
        """The fate of one dispatch attempt, or ``None`` (clean)."""
        p = self.plan
        rng = self._rng(0, round_idx, client_id, attempt)
        u = float(rng.uniform())
        edges = ((p.crash_rate, "crash"), (p.drop_rate, "drop"),
                 (p.corrupt_rate, "corrupt"), (p.diverge_rate, "diverge"),
                 (p.slowdown_rate, "slowdown"))
        acc = 0.0
        for rate, kind in edges:
            acc += rate
            if u < acc:
                fault = Fault(kind, int(client_id), int(round_idx),
                              int(attempt),
                              frac=float(rng.uniform(0.05, 0.95)),
                              factor=float(p.slowdown_factor))
                obs = obs_active()
                if obs is not None:
                    obs.metrics.counter("faults_injected", kind=kind).inc()
                return fault
        return None

    # ------------------------------------------------------------ payload
    def damage_tree(self, tree, fault: Fault):
        """Return a damaged copy of a payload tree.

        ``corrupt`` scrambles a seeded subset of float32 coordinates to
        finite ~1e38 garbage (exponent pinned to 254); ``diverge``
        overwrites the subset with NaN.  Non-float leaves pass through
        untouched.  The coordinates and the noise are drawn leaf by leaf
        over the wire layout (``fl.comm.codecs.to_wire``, the
        reference's), so the same fault hits the same coordinates as the
        reference's; they are scattered into copies of the float leaves
        on the payload's own device, each in its own dtype.  The
        original tensors (which other results may alias) are never
        written.
        """
        rng = self._rng(1, fault.round, fault.client, fault.attempt)
        frac = self.plan.corrupt_frac
        out = tree_map(lambda x: x.detach().clone(
            memory_format=torch.contiguous_format)
            if isinstance(x, torch.Tensor) and x.is_floating_point()
            else x, tree)
        wire = to_stacked_layout(out, stack=_Stacked, conv=_HWIO)
        for leaf in flatten(wire)[0]:
            if not _is_float_array(_first_part(leaf)):
                continue
            n = math.prod(leaf.shape)
            k = max(1, int(np.ceil(frac * n)))
            idx = rng.choice(n, size=min(k, n), replace=False)
            noise = None
            if fault.kind != "diverge":
                noise = rng.integers(0, 2 ** 23, size=idx.size,
                                     dtype=np.uint32)
            for part, flat, pos in _parts_of(leaf, idx,
                                             np.arange(idx.size)):
                _hit(part, flat, None if noise is None else noise[pos])
        return out

    def damage_result(self, result, fault: Fault):
        """Damage a :class:`~repro_torch.fl.strategy.ClientResult` payload in
        place (the result object is per-dispatch and engine-owned)."""
        result.payload = self.damage_tree(result.payload, fault)
        return result


class _Stacked:
    """A wire leaf stacked from congruent port tensors on a new axis 0."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.shape = (len(self.parts),) + tuple(self.parts[0].shape)


class _HWIO:
    """A ResNet conv weight (OIHW in the port) as its HWIO wire leaf."""

    def __init__(self, w):
        self.w = w
        o, i, h, kw = w.shape
        self.shape = (h, kw, i, o)


def _first_part(leaf):
    while isinstance(leaf, _Stacked):
        leaf = leaf.parts[0]
    return leaf.w if isinstance(leaf, _HWIO) else leaf


def _parts_of(leaf, flat: np.ndarray, pos: np.ndarray):
    """``(port tensor, its flat indices, positions in the draw)`` for the
    row-major wire coordinates ``flat`` of ``leaf``."""
    if isinstance(leaf, _Stacked):
        m = math.prod(leaf.shape[1:])
        layer = flat // m
        for i in np.unique(layer):
            sel = layer == i
            yield from _parts_of(leaf.parts[i], flat[sel] % m, pos[sel])
    elif isinstance(leaf, _HWIO):
        h, kw, i, o = np.unravel_index(flat, leaf.shape)
        _, n_in, n_h, n_w = leaf.w.shape
        yield leaf.w, ((o * n_in + i) * n_h + h) * n_w + kw, pos
    else:
        yield leaf, flat, pos


# the sign and mantissa bits of a float32, as an int32
_SIGN_MANTISSA = int(np.uint32(0x807FFFFF).view(np.int32))


def _hit(t: torch.Tensor, flat: np.ndarray, noise) -> None:
    """Damage ``t`` (a contiguous copy) at ``flat``: NaN without
    ``noise``, else the float32 bits XOR ``noise`` with the exponent
    pinned to 254, written back in ``t``'s dtype."""
    view = t.view(-1)
    ids = torch.from_numpy(flat.astype(np.int64)).to(t.device)
    if noise is None:
        view[ids] = float("nan")
        return
    bits = view[ids].float().view(torch.int32)
    scram = (bits ^ torch.from_numpy(noise.view(np.int32)).to(t.device)) \
        & _SIGN_MANTISSA
    view[ids] = (scram | (0xFE << 23)).view(torch.float32).to(t.dtype)


def as_injector(spec) -> Optional[FaultInjector]:
    """Resolve the engines' ``faults=`` knob: ``None`` -> off, a
    :class:`FaultPlan` -> wrapped, an injector passes through."""
    if spec is None:
        return None
    if isinstance(spec, FaultInjector):
        return spec
    if isinstance(spec, FaultPlan):
        return FaultInjector(spec)
    raise ValueError(f"faults must be None, a FaultPlan, or a "
                     f"FaultInjector, got {spec!r}")

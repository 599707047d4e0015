"""Pre-aggregation update validation / quarantine (port of
``repro.fl.faults.quarantine``, over trees of tensors).

The server's last line of defense: every client update is validated just
after decode and just before the strategy's ``aggregate`` sees it.  A
rejected ("quarantined") update never enters the average, and the
engines roll the comm channel's error-feedback residual back to its
pre-encode snapshot — the transmitted mass is retransmitted on the
client's next participation instead of being silently dropped
(``CommChannel.snapshot_uplink`` / ``rollback_uplink``).

Three checks, in order:

1. **Non-finite** — any NaN/Inf in a float leaf of the payload.
2. **Absolute magnitude** — any coordinate above ``abs_limit``
   (default 1e12).  Bit-corrupted float32 payloads land around 1e38.
3. **Norm outlier** — the update norm ``||payload - state||`` exceeds
   ``norm_factor`` times the median of recently ACCEPTED update norms.
   Self-calibrating, warm-up-gated (the first ``min_history`` accepted
   updates are never norm-rejected), and only applied when the payload
   is congruent with the server state — padded / masked / structured
   payloads (HeteroFL, SplitMix, DepthFL) are covered by checks 1-2.

The statistics are reduced on the tensors' device, one host read per
check; the norm accumulates in float64.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.fl.comm.codecs import flatten
from repro_torch.obs import active as obs_active


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Why one update was quarantined."""
    reason: str            # "nonfinite" | "abs" | "norm"
    detail: float = 0.0    # offending magnitude / norm ratio


def _float_leaves(tree) -> List[torch.Tensor]:
    return [t for t in flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel()]


def tree_finite_max(tree):
    """(all_finite, max_abs) over the float leaves of a tree; max_abs is
    taken over the finite coordinates."""
    leaves = _float_leaves(tree)
    if not leaves:
        return True, 0.0
    with torch.no_grad():
        stats = torch.stack([torch.stack((
            torch.isfinite(t).all().double(),
            torch.where(torch.isfinite(t), t.abs(),
                        torch.zeros((), dtype=t.dtype, device=t.device))
            .max().double())) for t in leaves]).cpu()
    return bool(stats[:, 0].all()), float(stats[:, 1].max())


def update_norm(payload, state) -> Optional[float]:
    """L2 norm of (payload - state) over float leaves, or ``None`` when
    the two trees are not congruent (structured payloads)."""
    p_leaves, p_struct = flatten(payload)
    s_leaves, s_struct = flatten(state)
    if p_struct != s_struct:
        return None
    sq = []
    with torch.no_grad():
        for p, s in zip(p_leaves, s_leaves):
            if not (isinstance(p, torch.Tensor) and p.is_floating_point()
                    and isinstance(s, torch.Tensor)
                    and p.shape == s.shape):
                continue
            d = p.double() - s.double()
            sq.append(torch.dot(d.reshape(-1), d.reshape(-1)))
    if not sq:
        return 0.0
    return math.sqrt(float(torch.stack(sq).sum()))


class UpdateValidator:
    """Stateful validator: remembers recently accepted update norms so
    the outlier threshold tracks the run's own scale."""

    def __init__(self, *, abs_limit: float = 1e12,
                 norm_factor: float = 100.0, min_history: int = 4,
                 history: int = 64):
        self.abs_limit = float(abs_limit)
        self.norm_factor = float(norm_factor)
        self.min_history = int(min_history)
        self._norms: collections.deque = collections.deque(maxlen=history)

    # ----------------------------------------------------------- export
    def export_state(self) -> dict:
        """Checkpointable state (the norm history IS the calibration —
        a resumed run must reject exactly what the uninterrupted run
        would)."""
        return {"norms": list(self._norms)}

    def import_state(self, state: dict) -> None:
        self._norms.clear()
        self._norms.extend(float(v) for v in state.get("norms", ()))

    # --------------------------------------------------------- validate
    def _median(self) -> Optional[float]:
        if len(self._norms) < self.min_history:
            return None
        return float(np.median(np.asarray(self._norms)))

    def validate_one(self, payload, state) -> Optional[Verdict]:
        """Verdict for ONE decoded payload against the current server
        state, updating the norm history on acceptance."""
        finite, mx = tree_finite_max(payload)
        if not finite:
            return Verdict("nonfinite", mx)
        if mx > self.abs_limit:
            return Verdict("abs", mx)
        norm = update_norm(payload, state)
        if norm is not None:
            med = self._median()
            if med is not None and med > 0.0 \
                    and norm > self.norm_factor * med:
                return Verdict("norm", norm / med)
            self._norms.append(norm)
        return None

    def observe_rejection(self, verdict: Verdict, client_id: int) -> None:
        """Count one rejection into an active telemetry capture."""
        obs = obs_active()
        if obs is not None:
            obs.metrics.counter("quarantined_updates",
                                reason=verdict.reason).inc()

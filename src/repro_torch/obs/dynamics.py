"""Learning-dynamics analytics at the aggregation boundary (port of
``repro.obs.dynamics``; docs/observability.md §Dynamics).

Both engines call :meth:`DynamicsAnalyzer.record_round` right where they
merge client results into the new global state — obs-gated and opt-in
within the capture (``Obs(dynamics=DynamicsAnalyzer())``).  Per merge
the analyzer computes, strictly read-only and in float64:

* per-client update norms ``||payload - state||`` and per-block norms of
  the aggregate delta (top-level parameter subtrees, list-valued
  subtrees split per depth index),
* update-vs-aggregate cosine drift,
* staleness-weighted contribution fractions ``w_i * (1 + tau_i)^-alpha /
  sum`` (the FedBuff discount; equal to
  :func:`repro_torch.fl.systime.staleness.polynomial_discount`, tested),
* participation equity: per-client merge counts and their Gini
  coefficient.

Quarantine rejections are overlaid via :meth:`record_rejection`.

The port's trees are tensors on the run's device.  The analyzer reads
them after the merge has produced the new state, casts each leaf to
float64 on its own device (a new tensor: nothing of the run is written)
and brings one scalar per tree back to the host, so its numbers are the
reference's up to the float64 summation order.  Payloads that are not
congruent with the global state (HeteroFL's ``(padded, mask)`` pairs,
masked FeDepth's tuples) are skipped per client with a
``dynamics_skipped{reason=}`` counter — the analyzer never raises into
the training path.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

#: Cosine values live in [-1, 1]; the histogram's matching buckets.
COSINE_BUCKETS = (-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)


def _discount(staleness: float, alpha: float) -> float:
    # FedBuff's polynomial rule — kept equal to
    # repro_torch.fl.systime.staleness.polynomial_discount (obs does not
    # import fl; the equality is tested)
    return float((1.0 + max(0.0, staleness)) ** -alpha)


def _gini(values: Sequence[float]) -> float:
    vals = sorted(float(v) for v in values)
    n, tot = len(vals), sum(vals)
    if n == 0 or tot <= 0:
        return 0.0
    cum = sum(i * v for i, v in enumerate(vals, 1))
    return (2.0 * cum) / (n * tot) - (n + 1) / n


def _flatten(tree):
    """(leaves, structure) in ``jax.tree_util.tree_flatten``'s order: dict
    keys sorted, sequences in order, ``None`` an empty subtree."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        if t is None:
            return None
        leaves.append(t)
        return "*"

    return leaves, walk(tree)


def _f64(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.detach().to(torch.float64)


def _delta_stats(a_leaves, b_leaves, agg_leaves=None):
    """||a - b||, and with ``agg_leaves`` the dot of (a - b) with the
    aggregate delta plus its norm — leaf-wise, never concatenated."""
    sq = dot = agg_sq = None
    for i, (la, lb) in enumerate(zip(a_leaves, b_leaves)):
        a = _f64(la)
        da = a - _f64(lb).to(a.device)
        s = torch.sum(da * da)
        sq = s if sq is None else sq + s.to(sq.device)
        if agg_leaves is not None:
            ga = agg_leaves[i].to(da.device)
            d, g = torch.sum(da * ga), torch.sum(ga * ga)
            dot = d if dot is None else dot + d.to(dot.device)
            agg_sq = g if agg_sq is None else agg_sq + g.to(agg_sq.device)

    def value(x):
        return 0.0 if x is None else float(x)

    return math.sqrt(value(sq)), value(dot), math.sqrt(value(agg_sq))


def _congruent(leaves, ref_leaves) -> bool:
    if len(leaves) != len(ref_leaves):
        return False
    return all(tuple(getattr(a, "shape", ())) == tuple(getattr(b, "shape",
                                                                ()))
               for a, b in zip(leaves, ref_leaves))


def new_leaves_minus(state_leaves, new_leaves):
    """The aggregate-delta leaves (new - state) in float64."""
    out = []
    for s, n in zip(state_leaves, new_leaves):
        n = _f64(n)
        out.append(n - _f64(s).to(n.device))
    return out


def _block_norms(state, new_state) -> Dict[str, float]:
    """Aggregate-delta norm per top-level parameter subtree; list-valued
    subtrees split per depth index."""

    def tree_norm(a, b) -> float:
        la, _ = _flatten(a)
        lb, _ = _flatten(b)
        return _delta_stats(lb, la)[0]

    if not (isinstance(state, dict) and isinstance(new_state, dict)
            and set(state) == set(new_state)):
        return {"all": tree_norm(state, new_state)}
    out: Dict[str, float] = {}
    for k in sorted(state, key=str):
        sv, nv = state[k], new_state[k]
        if (isinstance(sv, (list, tuple)) and isinstance(nv, (list, tuple))
                and len(sv) == len(nv)):
            for i, (a, b) in enumerate(zip(sv, nv)):
                out[f"{k}[{i}]"] = tree_norm(a, b)
        else:
            out[str(k)] = tree_norm(sv, nv)
    return out


class DynamicsAnalyzer:
    """Aggregation-boundary training diagnostics for one capture."""

    def __init__(self):
        self.rounds: List[dict] = []
        self.rejections: List[dict] = []
        self.participation: Dict[int, int] = {}
        self.rejected_counts: Dict[int, int] = {}
        self._contrib_sum: Dict[int, float] = {}
        self._metrics = None

    def bind(self, metrics) -> "DynamicsAnalyzer":
        self._metrics = metrics
        return self

    def reset(self) -> None:
        self.rounds.clear()
        self.rejections.clear()
        self.participation.clear()
        self.rejected_counts.clear()
        self._contrib_sum.clear()

    # ---------------------------------------------------------- recording
    def record_round(self, round_idx: int, state, results: Sequence,
                     new_state, *, clients: Optional[Sequence[int]] = None,
                     staleness: Optional[Sequence[float]] = None,
                     alpha: float = 0.5, engine: str = "round") -> None:
        """Analyze one merge: ``state`` is the pre-aggregate global
        parameters, ``results`` the merged ``ClientResult``s,
        ``new_state`` what the strategy produced.  Client ids come from
        ``result.client_id`` when stamped, else ``clients`` by position.
        Never raises."""
        try:
            with torch.no_grad():
                self._record_round(round_idx, state, results, new_state,
                                   clients=clients, staleness=staleness,
                                   alpha=alpha, engine=engine)
        except Exception:
            self._count("dynamics_skipped", reason="error")

    def _record_round(self, round_idx, state, results, new_state, *,
                      clients, staleness, alpha, engine) -> None:
        state_leaves, state_def = _flatten(state)
        new_leaves, new_def = _flatten(new_state)
        if new_def != state_def or not _congruent(new_leaves, state_leaves):
            self._count("dynamics_skipped", reason="state_structure")
            return
        agg_leaves = new_leaves_minus(state_leaves, new_leaves)
        agg_norm, _, _ = _delta_stats(new_leaves, state_leaves)

        rows, skipped = [], 0
        discounts, weights = [], []
        for i, res in enumerate(results):
            s = float(staleness[i]) if staleness is not None else 0.0
            discounts.append(_discount(s, alpha))
            weights.append(float(getattr(res, "weight", 1.0)))
        denom = sum(w * d for w, d in zip(weights, discounts)) or 1.0

        for i, res in enumerate(results):
            cid = getattr(res, "client_id", None)
            if cid is None:
                cid = int(clients[i]) if clients is not None \
                    and i < len(clients) else i
            payload = getattr(res, "payload", None)
            p_leaves, p_def = _flatten(payload)
            if p_def != state_def or not _congruent(p_leaves, state_leaves):
                skipped += 1
                self._count("dynamics_skipped", reason="payload_structure")
                continue
            norm, dot, a_norm = _delta_stats(p_leaves, state_leaves,
                                             agg_leaves)
            cosine = dot / (norm * a_norm) if norm > 0 and a_norm > 0 \
                else 0.0
            s = float(staleness[i]) if staleness is not None else 0.0
            contribution = weights[i] * discounts[i] / denom
            cid = int(cid)
            self.participation[cid] = self.participation.get(cid, 0) + 1
            self._contrib_sum[cid] = (self._contrib_sum.get(cid, 0.0)
                                      + contribution)
            rows.append({"client": cid, "weight": weights[i],
                         "staleness": s, "discount": discounts[i],
                         "contribution": contribution, "norm": norm,
                         "cosine": cosine})
            if self._metrics is not None:
                self._metrics.histogram("update_norm",
                                        engine=engine).observe(norm)
                self._metrics.histogram("update_cosine",
                                        buckets=COSINE_BUCKETS,
                                        engine=engine).observe(cosine)

        gini = _gini(self.participation.values())
        self.rounds.append({
            "round": int(round_idx), "engine": engine,
            "merged": len(results), "skipped_clients": skipped,
            "agg_norm": agg_norm,
            "block_norms": _block_norms(state, new_state),
            "participation_gini": gini, "clients": rows})
        if self._metrics is not None:
            self._metrics.counter("dynamics_rounds", engine=engine).inc()
            self._metrics.gauge("participation_gini").set(gini)

    def record_rejection(self, round_idx: int, client: int, reason: str,
                         *, engine: str = "round") -> None:
        """Overlay one quarantine rejection onto the dynamics timeline.
        Never raises."""
        try:
            cid = int(client)
            self.rejections.append({"round": int(round_idx), "client": cid,
                                    "reason": str(reason), "engine": engine})
            self.rejected_counts[cid] = self.rejected_counts.get(cid, 0) + 1
            self._count("dynamics_rejections", reason=str(reason))
        except Exception:
            self._count("dynamics_skipped", reason="error")

    def _count(self, name: str, **labels) -> None:
        if self._metrics is not None:
            self._metrics.counter(name, **labels).inc()

    # ----------------------------------------------------------- queries
    def client_summary(self) -> List[dict]:
        """Per-client equity and rejection rollup, one row per client."""
        ids = sorted(set(self.participation) | set(self.rejected_counts))
        out = []
        for cid in ids:
            merged = self.participation.get(cid, 0)
            reasons: Dict[str, int] = {}
            for rej in self.rejections:
                if rej["client"] == cid:
                    reasons[rej["reason"]] = reasons.get(rej["reason"], 0) + 1
            out.append({"client": cid, "merged": merged,
                        "rejected": self.rejected_counts.get(cid, 0),
                        "reasons": reasons,
                        "total_contribution": self._contrib_sum.get(cid,
                                                                    0.0)})
        return out


__all__ = ["DynamicsAnalyzer", "COSINE_BUCKETS"]

"""Per-client error feedback (EF-SGD) for lossy uplink codecs (port of
``repro.fl.comm.error_feedback``).

A lossy codec throws information away every round; EF-SGD (Seide et al.
2014; Karimireddy et al. 2019) keeps a per-client residual — everything
the codec failed to transmit so far — and adds it back into the next
update before encoding:

    corrected_t = delta_t + e_{t-1}
    wire_t      = encode(corrected_t)
    e_t         = corrected_t - decode(wire_t)

The residual lives client-side in a deployment; here the
:class:`~repro_torch.fl.comm.payload.CommChannel` holds one per client
id, as a tree of fp32 tensors beside the update it corrects.  A residual
is re-applied only while it describes the same coordinates: it is
dropped when the outgoing tree's structure changes, and when the
strategy's wire ``tag`` changes (two same-capacity SplitMix base subsets
share their structure but not their networks).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.fl.comm.codecs import _is_float_array, trees_congruent
from repro_torch.tree import tree_map


class ErrorFeedback:
    """Per-client residual store.  ``correct`` adds the residual into an
    outgoing update, ``update`` records what the codec just failed to
    transmit.  ``store`` (any ``repro_torch.fl.scale.state_store``
    ClientStateStore, e.g. a bounded ``SpillStore``) holds the residuals;
    the default is a plain dict."""

    def __init__(self, store=None):
        # id -> (tag, residual); a dict satisfies the store protocol
        self._residuals = store if store is not None else {}

    def residual(self, client_id: int):
        entry = self._residuals.get(client_id)
        return entry[1] if entry is not None else None

    def reset(self, client_id: Optional[int] = None) -> None:
        if client_id is None:
            self._residuals.clear()
        else:
            self._residuals.pop(client_id, None)

    def correct(self, client_id: int, tree, tag=None):
        """``tree + residual`` (float leaves only).  A residual whose
        structure or wire tag no longer matches the outgoing update is
        dropped, never misapplied to different coordinates."""
        entry = self._residuals.get(client_id)
        if entry is None:
            return tree
        old_tag, res = entry
        if old_tag != tag or not trees_congruent(tree, res):
            self.reset(client_id)
            return tree
        return tree_map(lambda t, r: t.float() + r
                        if _is_float_array(t) else t, tree, res)

    def update(self, client_id: int, corrected, decoded, tag=None) -> None:
        """Store ``corrected - decoded``, the part of this round's
        (already corrected) update the codec dropped.  A non-float leaf
        keeps the outgoing leaf as a placeholder, so the stored tree stays
        congruent with the next round's update."""
        self._residuals[client_id] = (tag, tree_map(
            lambda c, d: c.float() - d.float() if _is_float_array(c) else c,
            corrected, decoded))

    # ------------------------------------------------ checkpoint / resume
    def export_state(self) -> list:
        """Every residual entry as ``[client_id, (tag, residual)]``."""
        return [[k, self._residuals.get(k)]
                for k in sorted(self._residuals.keys(), key=repr)]

    def import_state(self, entries: list) -> None:
        self._residuals.clear()
        for k, entry in entries:
            self._residuals[k] = tuple(entry) if isinstance(entry, list) \
                else entry

    # ---------------------------------------------- delivery rollback
    def snapshot(self, client_id: int):
        """Opaque pre-encode state for :meth:`restore`."""
        return self._residuals.get(client_id)

    def restore(self, client_id: int, snap) -> None:
        """Undo an encode whose payload the server discarded: the
        residual reverts to its pre-encode value."""
        if snap is None:
            self._residuals.pop(client_id, None)
        else:
            self._residuals[client_id] = snap

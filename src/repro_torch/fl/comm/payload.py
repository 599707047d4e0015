"""The wire contract: what crosses the link, in both directions (port of
``repro.fl.comm.payload``).

**Uplink** — a strategy's ``ClientResult`` payload is split by an
optional ``wire_parts(ctx, state, result)`` hook into a :class:`WireSpec`:
the tree that goes on the wire, a congruent reference for delta coding
(the broadcast state both ends hold: untouched prefixes delta to exact
zeros), an optional coordinate mask (HeteroFL's width slice), and a
``rebuild`` closure restoring the strategy's payload shape after decode.
Strategies without the hook get :func:`default_wire_parts`.  The channel
adds per-client error feedback, encodes, and stamps the exact encoded
byte count into ``ClientResult.comm_bytes``; the payload then carries a
:class:`WireUpdate` until the engine decodes it just before
``aggregate``.

**Downlink** — three accounting modes on :class:`CommChannel`:

* ``"full"``   — every participant downloads the whole server state.
* ``"sliced"`` — each client downloads only the subtree its strategy's
  ``downlink_tree(ctx, state, client_id)`` hook declares (HeteroFL its
  width slice, DepthFL its depth prefix, SplitMix its base nets; FeDepth's
  depth-wise slices telescope to the full model).
* ``"delta"``  — sliced, and a repeat participant receives only the
  coordinates that changed since its last-seen version, priced as (fp32
  value + i32 index) pairs capped at the dense size, per leaf of the wire
  layout (``codecs``).

Content is exact in every downlink mode: only the bytes change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.fl.comm.codecs import (Codec, WirePayload, _is_float_array,
                                        get_codec, trees_congruent, wire_sums)
from repro_torch.fl.comm.error_feedback import ErrorFeedback
from repro_torch.obs import active as obs_active
from repro_torch.tree import tree_bytes, tree_leaves, tree_map

DOWNLINK_MODES = ("full", "sliced", "delta")


def tree_sub(a, b):
    """Float-leaf-wise ``a - b``; other leaves pass through from ``a``."""
    return tree_map(lambda x, y: x - y if _is_float_array(x) else x, a, b)


def tree_add(ref, delta):
    """Inverse of :func:`tree_sub`: ``ref + delta`` on float leaves (in
    fp32, back in ``ref``'s dtype), the delta's own value elsewhere."""
    return tree_map(lambda r, d: (r.float() + d.float()).to(r.dtype)
                    if _is_float_array(r) else d, ref, delta)


@dataclasses.dataclass
class WireSpec:
    """How one ClientResult maps onto the wire (see the module
    docstring).  ``tag`` is the error-feedback identity: a residual only
    applies to a later round whose tag matches (SplitMix tags its base
    ids)."""
    tree: Any                                 # the tree to encode
    ref: Any = None                           # congruent delta base, or None
    mask: Any = None                          # 0/1 coordinate mask, or None
    rebuild: Optional[Callable] = None        # decoded tree -> payload shape
    tag: Any = None


@dataclasses.dataclass
class WireUpdate:
    """An encoded client update in flight: the ``WirePayload`` that
    crossed the link plus what the server needs to decode it.
    ``decoded`` carries the tree the error-feedback path already decoded,
    so aggregation does not decode it again."""
    wire: WirePayload
    codec: Codec
    ref: Any = None
    rebuild: Optional[Callable] = None
    decoded: Any = None

    @property
    def nbytes(self) -> int:
        return self.wire.nbytes

    def decode(self):
        tree = self.decoded if self.decoded is not None \
            else self.codec.decode(self.wire)
        if self.ref is not None:
            tree = tree_add(self.ref, tree)
        return self.rebuild(tree) if self.rebuild is not None else tree


def default_wire_parts(ctx, state, result) -> WireSpec:
    """Delta against the broadcast state when the payload is congruent
    with it (FedAvg's subnet, FeDepth's full model), else the payload
    tree coded as it is."""
    payload = result.payload
    try:
        congruent = trees_congruent(payload, state)
    except Exception:
        congruent = False
    if congruent:
        return WireSpec(payload, ref=state)
    return WireSpec(payload)


def _changed(new, old) -> np.ndarray:
    """[changed coordinates, bytes] of one leaf against its last-seen
    version (a leaf passed through by reference changed nowhere)."""
    if not isinstance(new, torch.Tensor):
        return np.zeros(2, np.int64)
    nnz = 0 if new is old else int(torch.count_nonzero(new != old))
    return np.array([nnz, new.numel() * new.element_size()], np.int64)


class CommChannel:
    """One experiment's wire: codec and per-client error feedback (always
    on) on the uplink, slicing / delta accounting on the downlink.  ``RoundEngine(codec=...,
    downlink=...)`` owns one and routes every byte it reports through
    it."""

    def __init__(self, codec: Union[str, Codec, None] = "none",
                 downlink: str = "full", *, state_store=None):
        """``state_store`` (a ``repro_torch.fl.scale.state_store``
        ClientStateStore, e.g. a bounded ``SpillStore``) backs both
        per-client maps the channel keeps — error-feedback residuals and
        the delta downlink's last-seen tracker — under ``"ef"`` /
        ``"downlink"`` namespaces of the one store.  ``None`` keeps plain
        dicts."""
        self.codec = get_codec(codec)
        if downlink not in DOWNLINK_MODES:
            raise ValueError(f"downlink must be one of {DOWNLINK_MODES}, "
                             f"got {downlink!r}")
        self.downlink = downlink
        if state_store is not None:
            from repro_torch.fl.scale.state_store import PrefixedStore
            self.ef = ErrorFeedback(PrefixedStore(state_store, "ef"))
            self._last_sent = PrefixedStore(state_store, "downlink")
        else:
            self.ef = ErrorFeedback()
            self._last_sent: Dict[int, Any] = {}   # client -> last-seen

    # -------------------------------------------------------------- uplink
    def encode_result(self, strategy, ctx, state, client_id: int, result):
        """Encode one ClientResult for the wire (in place).  The "none"
        codec is a strict no-op: the result, its payload and
        ``comm_bytes`` pass through untouched."""
        if self.codec.name == "none":
            return result
        spec_fn = getattr(strategy, "wire_parts", None)
        spec = spec_fn(ctx, state, result) if spec_fn is not None \
            else default_wire_parts(ctx, state, result)
        with torch.no_grad():
            delta = tree_sub(spec.tree, spec.ref) if spec.ref is not None \
                else spec.tree
            corrected = self.ef.correct(client_id, delta, tag=spec.tag)
            wire = self.codec.encode(corrected, mask=spec.mask)
            decoded = self.codec.decode(wire)
            self.ef.update(client_id, corrected, decoded, tag=spec.tag)
        obs = obs_active()
        if obs is not None:
            self._record(obs, client_id, spec.tree, wire, corrected,
                         decoded)
        result.payload = WireUpdate(wire, self.codec, ref=spec.ref,
                                    rebuild=spec.rebuild, decoded=decoded)
        result.comm_bytes = wire.nbytes
        return result

    def _record(self, obs, client_id: int, tree, wire, corrected,
                decoded) -> None:
        """The encode's telemetry: the encode ratio against the raw
        tree, the encoded bytes, and the norm of the residual error
        feedback just stored (corrected - decoded on float leaves, in
        float64; read-only)."""
        raw = tree_bytes(tree)
        if raw > 0:
            obs.metrics.histogram(
                "codec_encode_ratio",
                codec=self.codec.name).observe(wire.nbytes / raw)
        obs.metrics.counter("codec_encoded_bytes",
                            codec=self.codec.name).inc(wire.nbytes)
        sq = 0.0
        with torch.no_grad():
            for c, d in zip(tree_leaves(corrected), tree_leaves(decoded)):
                if _is_float_array(c):
                    diff = c.double() - d.double().to(c.device)
                    sq += float(torch.sum(diff * diff))
        obs.metrics.gauge("ef_residual_norm",
                          client=client_id).set(math.sqrt(sq))

    def decode_result(self, result):
        """Server-side decode (in place), just before the strategy's
        aggregate sees the result."""
        if isinstance(result.payload, WireUpdate):
            with torch.no_grad():
                result.payload = result.payload.decode()
        return result

    def snapshot_uplink(self, client_id: int):
        """Pre-encode error-feedback state, for engines whose delivery
        can still fail after encoding (a deadline miss, a quarantine)."""
        return self.ef.snapshot(client_id)

    def rollback_uplink(self, client_id: int, snap) -> None:
        """Undo :meth:`encode_result`'s residual update for a payload the
        server discarded (``ErrorFeedback.restore``)."""
        self.ef.restore(client_id, snap)

    # ------------------------------------------------ checkpoint / resume
    def export_state(self) -> dict:
        """The channel's state in checkpointable form: the error-feedback
        residuals, the delta downlink's last-seen tracker and a
        stochastic codec's own stream (qsgd's), all part of the bitwise
        resume contract.  The reference carries the first two only, so
        its resumed runs under ``qsgd_int8`` restart the codec's stream
        (ROADMAP §3, fault 16)."""
        codec = getattr(self.codec, "export_state", None)
        return {"ef": self.ef.export_state(),
                "last_sent": [[k, self._last_sent.get(k)]
                              for k in sorted(self._last_sent.keys(),
                                              key=repr)],
                "codec": codec() if codec is not None else None}

    def import_state(self, state: dict) -> None:
        if state.get("codec") is not None \
                and hasattr(self.codec, "import_state"):
            self.codec.import_state(state["codec"])
        if state.get("ef") is not None:
            self.ef.import_state(state["ef"])
        self._last_sent.clear()
        for k, v in state.get("last_sent", []):
            self._last_sent[k] = v

    # ------------------------------------------------------------ downlink
    def downlink_bytes(self, strategy, ctx, state, client_id: int) -> int:
        """Wire size of what the server ships ``client_id`` this dispatch
        (and, in delta mode, record it as last-seen)."""
        hook = getattr(strategy, "downlink_tree", None)
        if self.downlink == "full":
            full = tree_bytes(state)
            if full == 0 and hook is not None:
                # a state that is no tree of tensors (SplitMixState) is
                # priced through the hook's needed tree
                full = tree_bytes(hook(ctx, state, client_id))
            return full
        tree = hook(ctx, state, client_id) if hook is not None else state
        if self.downlink == "sliced":
            return tree_bytes(tree)
        return self._delta_bytes(client_id, tree)

    def _delta_bytes(self, client_id: int, tree) -> int:
        """Changed-coordinate downlink against the client's last-seen
        version: 8 bytes a changed coordinate, capped at each wire-layout
        leaf's dense fp32 size (a stacked layer leaf is one leaf, as in
        the reference).  The tracker pins each client's last-seen tree
        by reference."""
        dense = tree_bytes(tree)
        prev = self._last_sent.get(client_id)
        total = dense
        if prev is not None and trees_congruent(tree, prev):
            changed = wire_sums(_changed, tree, prev)
            total = min(sum(min(8 * int(nnz), int(nbytes))
                            for nnz, nbytes in changed), dense)
        self._last_sent[client_id] = tree
        return int(total)

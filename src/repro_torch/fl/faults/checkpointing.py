"""Crash-safe engine checkpoint / resume (port of
``repro.fl.faults.checkpointing``).

A checkpoint is a PAIR of files per round, both written atomically:

``round_NNNNNN.npz``
    The server model state (a tree of tensors) via
    :mod:`repro_torch.train.checkpoint` — the reference's file layout.
``round_NNNNNN.aux``
    Everything ELSE bitwise continuation needs, as one
    :mod:`repro_torch.fl.scale.state_store` blob: the shared ``ctx.rng``
    bit-generator state, comm-channel error-feedback residuals and
    delta-downlink tracker, the history rows emitted so far, byte
    accumulators, validator calibration, and (async) the materialized
    event loop — clock, heap with the in-flight payloads, running set,
    version, trace.

Every tensor in the aux blob is written as host numpy with its dtype
(``state_store.host_tree``), so no device tensor is ever serialized,
and comes back a tensor on the device the run resumes on, in its dtype
(``state_store.device_tree``).  This holds on the blob's pickle path too (no
``msgpack`` in the environment).

``load_latest`` walks retained rounds newest-first and requires BOTH
halves to load; a torn pair (server died between the two writes, or a
corrupt file) is skipped with a warning and the previous round is used.
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Any, Optional, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.scale import state_store
from repro_torch.fl.scale.state_store import (device_tree,  # noqa: F401
                                              host_tree)
from repro_torch.obs import active as obs_active
from repro_torch.train import checkpoint as ckpt

def _aux_path(npz_path: str) -> str:
    return npz_path[:-len(".npz")] + ".aux"


class EngineCheckpointer:
    """Periodic paired-file checkpoints for the FL engines."""

    def __init__(self, ckpt_dir: str, every: int, *, keep: int = 3):
        if every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {every}")
        self.dir = ckpt_dir
        self.every = int(every)
        self.keep = int(keep)

    def due(self, round_idx: int) -> bool:
        """Rounds are 0-based; ``every=k`` checkpoints after rounds
        k-1, 2k-1, ... (i.e. every k completed rounds)."""
        return (round_idx + 1) % self.every == 0

    # ------------------------------------------------------------------ io
    def save(self, round_idx: int, server_tree: Any, aux: dict) -> str:
        """Write the pair: aux blob first, npz second — ``load_latest``
        requires both, so a crash between the writes leaves a torn pair
        that resume skips (never a half-resumed run)."""
        path = os.path.join(self.dir, f"round_{round_idx:06d}.npz")
        state_store.dump_blob(_aux_path(path), host_tree(aux))
        ckpt.save_round(self.dir, round_idx, server_tree, keep=self.keep)
        self._gc_aux()
        obs = obs_active()
        if obs is not None:
            obs.metrics.counter("checkpoints_written").inc()
        return path

    def _gc_aux(self) -> None:
        """Drop aux blobs whose npz half was retention-GC'd."""
        if not os.path.isdir(self.dir):
            return
        for f in os.listdir(self.dir):
            if re.fullmatch(r"round_\d+\.aux", f) \
                    and not os.path.exists(os.path.join(
                        self.dir, f[:-len(".aux")] + ".npz")):
                os.remove(os.path.join(self.dir, f))

    def load_latest(self, device: DeviceLike = None
                    ) -> Optional[Tuple[int, Any, dict]]:
        """Newest fully-loadable ``(round_idx, server_tree, aux)`` with
        every tensor on ``device`` (the GPU unless ``"cpu"`` is asked
        for; raises when the GPU is implied and there is none), or
        ``None`` when no usable checkpoint exists."""
        device = resolve_device(device)
        if not os.path.isdir(self.dir):
            return None
        rounds = sorted((f for f in os.listdir(self.dir)
                         if re.fullmatch(r"round_\d+\.npz", f)),
                        reverse=True)
        for f in rounds:
            path = os.path.join(self.dir, f)
            try:
                tree, metadata = ckpt.load(path, device=device)
                aux = device_tree(state_store.load_blob(_aux_path(path)),
                                  device)
            except Exception as e:
                warnings.warn(f"skipping unusable checkpoint {path}: {e}")
                continue
            obs = obs_active()
            if obs is not None:
                obs.metrics.counter("checkpoints_resumed").inc()
            return int(metadata.get("round", -1)), tree, aux
        return None

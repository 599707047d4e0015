"""Per-client state stores and serialized state blobs (port of
``repro.fl.scale.state_store``; docs/scale.md §State store).

Per-client server-side state — error-feedback residuals
(``fl/comm/error_feedback.py``), the delta-downlink last-seen tracker
(``fl/comm/payload.py``), duty-cycle phases
(``fl/systime/availability.py``), async in-flight snapshots
(``fl/systime/engine.py``) — lives in plain dicts by default, which grow
with every client ever touched.  A :class:`ClientStateStore` is the
drop-in replacement: :class:`SpillStore` offers the same ``get`` /
``__setitem__`` / ``pop`` / ``clear`` surface, bounding the HOT set to
an LRU of ``capacity`` entries and spilling the rest to disk, and
:class:`PrefixedStore` lets one store back several subsystems.  The
engines' checkpoint blobs (:func:`dump_blob` / :func:`load_blob`) use
the same codec.

**Tensors.**  A resident entry is held as it was given: its tensors stay
on their device.  An entry that leaves the hot set goes to the host
(:func:`host_tree`: every tensor a tagged numpy copy with its dtype, so
no device tensor is ever serialized) and comes back on the device it
left from, in its dtype (:func:`device_tree`) — bitwise the value that
was spilled.  The spill, disk-load and hot-hit counters are recorded
into an active telemetry capture (``repro_torch.obs``).

Serialization is msgpack framing over a small recursive codec that
round-trips the trees these call sites store — dicts, lists, TUPLES
(tuple-vs-list is tree structure), numpy arrays, scalars, None — with a
pickle escape hatch for anything richer (dataclasses, 128-bit ints).
Without ``msgpack`` in the environment, values are pickled whole.
Array leaves re-materialize as numpy; tensors travel through
:func:`host_tree` / :func:`device_tree`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import shutil
import tempfile
from collections import OrderedDict
from typing import Any, Iterator, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.obs import active as obs_active

try:                                    # optional: pickle without it
    import msgpack
except ImportError:                     # pragma: no cover - gated fallback
    msgpack = None


@runtime_checkable
class ClientStateStore(Protocol):
    """Dict-shaped per-client state storage.  A plain ``dict`` satisfies
    it; :class:`SpillStore` adds bounded residency.  Keys must be
    hashable with a stable ``repr`` (ints, strings, tuples thereof)."""

    def get(self, key, default=None): ...

    def __setitem__(self, key, value) -> None: ...

    def pop(self, key, default=None): ...

    def clear(self) -> None: ...

    def __len__(self) -> int: ...

    def __contains__(self, key) -> bool: ...


class InMemoryStore(dict):
    """The trivial store: a dict with the protocol spelled out."""


class PrefixedStore:
    """Namespace view over a shared store: keys become ``(prefix, key)``.
    Lets ONE :class:`SpillStore` back several subsystems (EF residuals,
    the downlink tracker, in-flight snapshots) without key collisions;
    ``clear`` only drops this namespace's keys."""

    def __init__(self, store, prefix):
        self.store = store
        self.prefix = prefix

    def _k(self, key):
        return (self.prefix, key)

    def get(self, key, default=None):
        return self.store.get(self._k(key), default)

    def __setitem__(self, key, value) -> None:
        self.store[self._k(key)] = value

    def pop(self, key, default=None):
        return self.store.pop(self._k(key), default)

    def __contains__(self, key) -> bool:
        return self._k(key) in self.store

    def __len__(self) -> int:
        return sum(1 for k in self.store.keys()
                   if isinstance(k, tuple) and k and k[0] == self.prefix)

    def keys(self):
        return [k[1] for k in self.store.keys()
                if isinstance(k, tuple) and k and k[0] == self.prefix]

    def clear(self) -> None:
        for k in self.keys():
            self.store.pop(self._k(k), None)


# --------------------------------------------------------------------------
# tensors <-> host numpy
# --------------------------------------------------------------------------
_TORCH = "__torch__"


def host_tree(obj):
    """``obj`` with every tensor replaced by ``{"__torch__": [dtype name,
    numpy copy]}`` (bf16 as float32, exact), through dicts, lists,
    tuples (named ones too) and dataclasses; other leaves as they are."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        host = (t.float() if t.dtype == torch.bfloat16 else t).cpu()
        return {_TORCH: [str(t.dtype).split(".")[-1], host.numpy()]}
    return _rebuild(obj, host_tree)


def device_tree(obj, device):
    """Inverse of :func:`host_tree`: each tagged array becomes a tensor
    on ``device`` in its recorded dtype."""
    if isinstance(obj, dict) and set(obj) == {_TORCH}:
        dtype, arr = obj[_TORCH]
        return torch.from_numpy(np.array(arr)).to(device).to(
            getattr(torch, dtype))
    return _rebuild(obj, lambda v: device_tree(v, device))


def _rebuild(obj, fn):
    if isinstance(obj, dict):
        return {k: fn(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(fn(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(fn(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def tensor_device(obj) -> Optional[torch.device]:
    """The device of the first tensor found in ``obj`` (through dicts,
    sequences and dataclasses), or ``None`` when it holds none."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return None
    for v in items:
        d = tensor_device(v)
        if d is not None:
            return d
    return None


# --------------------------------------------------------------------------
# msgpack/np pytree codec
# --------------------------------------------------------------------------
_ND, _TUPLE, _PICKLE = "__nd__", "__tuple__", "__pickle__"


def _encode(obj):
    """Recursive pytree -> msgpack-able structure.  Tuples and array
    leaves are tagged so structure survives the round trip exactly."""
    if isinstance(obj, bool) or obj is None \
            or isinstance(obj, (float, str, bytes)):
        return obj
    if isinstance(obj, int):
        # msgpack ints are capped at 64 bits; numpy PCG64 rng state
        # carries 128-bit ints, so big ints take the pickle escape hatch
        if -(2 ** 63) <= obj < 2 ** 64:
            return obj
        return {_PICKLE: pickle.dumps(obj)}
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        return {_ND: [a.dtype.str, list(a.shape), a.tobytes()]}
    if isinstance(obj, tuple):
        return {_TUPLE: [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj) \
            and not (set(obj) & {_ND, _TUPLE, _PICKLE}):
        return {k: _encode(v) for k, v in obj.items()}
    # anything richer (dataclasses, non-string dict keys): pickle the
    # whole subtree
    return {_PICKLE: pickle.dumps(obj)}


def _decode(obj):
    if isinstance(obj, dict):
        if _ND in obj:
            dtype, shape, buf = obj[_ND]
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        if _TUPLE in obj:
            return tuple(_decode(v) for v in obj[_TUPLE])
        if _PICKLE in obj:
            return pickle.loads(obj[_PICKLE])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def dumps(value) -> bytes:
    """Serialize one store value (msgpack framing, pickle fallback when
    msgpack is unavailable in the environment)."""
    if msgpack is None:                  # pragma: no cover - gated fallback
        return pickle.dumps(value)
    return msgpack.packb(_encode(value), use_bin_type=True)


def loads(blob: bytes):
    if msgpack is None:                  # pragma: no cover - gated fallback
        return pickle.loads(blob)
    return _decode(msgpack.unpackb(blob, raw=False, strict_map_key=False))


def dump_blob(path: str, value) -> None:
    """Atomically write one serialized value to ``path`` (tmp file +
    ``os.replace`` so a crash mid-write never leaves a partial blob —
    the checkpoint / resume contract)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(dumps(value))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_blob(path: str):
    with open(path, "rb") as f:
        return loads(f.read())


# --------------------------------------------------------------------------
# the LRU + spill store
# --------------------------------------------------------------------------
class SpillStore:
    """LRU-bounded hot set with spill-to-disk for everything colder.

    At most ``capacity`` entries stay resident; touching an entry
    (read or write) makes it most-recently-used, and inserts beyond
    capacity evict the LRU entry to ``dir`` as one msgpack/np blob per
    key.  ``pop`` / ``clear`` delete spilled blobs too, so disk usage
    tracks live state.  The hot-set bound is an invariant (asserted in
    tests/test_torch_faults.py and tests/test_torch_scale.py):
    ``resident() <= capacity`` after every operation.  A spilled entry's
    tensors go to disk as host numpy and come back on the device they
    left from, in their dtype (module docstring).
    """

    def __init__(self, capacity: int, *, dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._hot: OrderedDict = OrderedDict()
        self._spilled: dict = {}           # key -> (filename, device)
        self._dir = dir
        self._own_dir = dir is None
        self.spill_count = 0               # evictions, for tests/benches
        self.load_count = 0                # disk reloads

    # ------------------------------------------------------------- paths
    def _ensure_dir(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="repro-spill-")
        else:
            os.makedirs(self._dir, exist_ok=True)
        return self._dir

    def _path(self, key) -> str:
        h = hashlib.sha1(repr(key).encode()).hexdigest()
        return os.path.join(self._ensure_dir(), f"{h}.msgpack")

    # --------------------------------------------------------------- core
    def _obs_counter(self, name: str):
        obs = obs_active()
        return None if obs is None else obs.metrics.counter(
            name, store="spill")

    def _evict_to_capacity(self) -> None:
        while len(self._hot) > self.capacity:
            key, value = self._hot.popitem(last=False)     # LRU out
            path = self._path(key)
            device = tensor_device(value)
            with open(path, "wb") as f:
                f.write(dumps(host_tree(value) if device is not None
                              else value))
            self._spilled[key] = (path, device)
            self.spill_count += 1
            c = self._obs_counter("state_store_evictions")
            if c is not None:
                c.inc()

    def _load(self, entry):
        path, device = entry
        with open(path, "rb") as f:
            value = loads(f.read())
        os.remove(path)
        self.load_count += 1
        c = self._obs_counter("state_store_disk_loads")
        if c is not None:
            c.inc()
        return device_tree(value, device) if device is not None else value

    def get(self, key, default=None):
        if key in self._hot:
            self._hot.move_to_end(key)
            c = self._obs_counter("state_store_hot_hits")
            if c is not None:
                c.inc()
            return self._hot[key]
        entry = self._spilled.pop(key, None)
        if entry is None:
            return default
        value = self._load(entry)
        self._hot[key] = value                              # promote
        self._evict_to_capacity()
        return value

    def __getitem__(self, key):
        sentinel = object()
        out = self.get(key, sentinel)
        if out is sentinel:
            raise KeyError(key)
        return out

    def __setitem__(self, key, value) -> None:
        if key in self._spilled:
            os.remove(self._spilled.pop(key)[0])
        self._hot[key] = value
        self._hot.move_to_end(key)
        self._evict_to_capacity()

    def pop(self, key, default=None):
        if key in self._hot:
            c = self._obs_counter("state_store_hot_hits")
            if c is not None:
                c.inc()
            return self._hot.pop(key)
        entry = self._spilled.pop(key, None)
        if entry is None:
            return default
        return self._load(entry)

    def clear(self) -> None:
        self._hot.clear()
        for path, _ in self._spilled.values():
            if os.path.exists(path):
                os.remove(path)
        self._spilled.clear()

    # ---------------------------------------------------------- inventory
    def __contains__(self, key) -> bool:
        return key in self._hot or key in self._spilled

    def __len__(self) -> int:
        return len(self._hot) + len(self._spilled)

    def keys(self) -> Iterator[Any]:
        return list(self._hot.keys()) + list(self._spilled.keys())

    def resident(self) -> int:
        """Entries currently held in host memory (the LRU invariant:
        always <= ``capacity``)."""
        return len(self._hot)

    def close(self) -> None:
        """Drop everything; remove the spill directory if we made it."""
        self.clear()
        if self._own_dir and self._dir is not None \
                and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

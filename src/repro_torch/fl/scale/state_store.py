"""Serialized state blobs and a spilling per-client store (port of
``repro.fl.scale.state_store``: its codec, blobs and ``SpillStore``, a
copy with numpy only).

Per-client server-side state — error-feedback residuals, the
delta-downlink last-seen tracker, duty-cycle phases, async in-flight
snapshots — can live in plain host dicts that grow with every client
ever touched.  :class:`SpillStore` offers the same ``get`` /
``__setitem__`` / ``pop`` / ``clear`` surface, bounding the HOT set to
an LRU of ``capacity`` entries and spilling the rest to disk.  The
engines' checkpoint blobs (:func:`dump_blob` / :func:`load_blob`) use
the same codec.

Serialization is msgpack framing over a small recursive codec that
round-trips the trees these call sites store — dicts, lists, TUPLES
(tuple-vs-list is tree structure), numpy arrays, scalars, None — with a
pickle escape hatch for anything richer (dataclasses, 128-bit ints).
Without ``msgpack`` in the environment, values are pickled whole.
Array leaves re-materialize as numpy: callers that hold tensors convert
them to host numpy first (``fl.faults.checkpointing`` does), so no
device tensor is ever serialized.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tempfile
from collections import OrderedDict
from typing import Any, Iterator, Optional

import numpy as np

try:                                    # optional: pickle without it
    import msgpack
except ImportError:                     # pragma: no cover - gated fallback
    msgpack = None


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
    tests/test_torch_faults.py): ``resident() <= capacity`` after every
    operation.
    """

    def __init__(self, capacity: int, *, dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._hot: OrderedDict = OrderedDict()
        self._spilled: dict = {}           # key -> filename
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
    def _evict_to_capacity(self) -> None:
        while len(self._hot) > self.capacity:
            key, value = self._hot.popitem(last=False)     # LRU out
            path = self._path(key)
            with open(path, "wb") as f:
                f.write(dumps(value))
            self._spilled[key] = path
            self.spill_count += 1

    def get(self, key, default=None):
        if key in self._hot:
            self._hot.move_to_end(key)
            return self._hot[key]
        path = self._spilled.pop(key, None)
        if path is None:
            return default
        with open(path, "rb") as f:
            value = loads(f.read())
        os.remove(path)
        self.load_count += 1
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
            os.remove(self._spilled.pop(key))
        self._hot[key] = value
        self._hot.move_to_end(key)
        self._evict_to_capacity()

    def pop(self, key, default=None):
        if key in self._hot:
            return self._hot.pop(key)
        path = self._spilled.pop(key, None)
        if path is None:
            return default
        with open(path, "rb") as f:
            value = loads(f.read())
        os.remove(path)
        self.load_count += 1
        return value

    def clear(self) -> None:
        self._hot.clear()
        for path in self._spilled.values():
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

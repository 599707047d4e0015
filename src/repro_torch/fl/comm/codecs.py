"""Pluggable wire codecs: what a client update looks like on the link
(port of ``repro.fl.comm.codecs``).

A :class:`Codec` turns a tree of float tensors into a :class:`WirePayload`
carrying the exact encoded byte count — the number the engine stamps
into ``ClientResult.comm_bytes`` — and back.  Four built-ins, registered
by name:

========== ===================================================== =========
name       wire format (per float leaf)                          bytes/coord
========== ===================================================== =========
none       float32 values, by reference                          4
fp16       float16 cast (values clipped to the fp16 range)       2
qsgd_int8  QSGD stochastic int8 quantization + one fp32 scale    1 (+4/leaf)
topk       top-k |value| sparsification: fp32 value + i32 index  8 * k_frac
========== ===================================================== =========

Every codec optionally takes a ``mask`` (a congruent 0/1 tree): only
coordinates inside the mask are encoded and counted — HeteroFL's padded
width slices put exactly the slice on the wire.  Non-float leaves pass
through verbatim, priced at their bytes (Python scalars free).

**The wire layout.**  A tree is encoded in the stacked layout
(``repro_torch.layout``), the reference's: each list of layers is one
leaf stacked on a leading layer axis, a ResNet's conv weights are HWIO.
So a leaf's codec state — qsgd's scale, topk's k — spans the same
coordinates as the reference's, the bytes are the same, and qsgd's
stochastic rounding draws its stream over the same coordinates in the
same order.  Tensors go to host numpy for encoding; ``decode`` returns
the port's layout, as tensors on the device the encoded tree lived on.

``qsgd_int8`` is the only stochastic codec: it draws from its own
``np.random.default_rng(seed)``, never the simulation stream.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple, \
    Union

import numpy as np
import torch

from repro_torch.layout import from_stacked_layout, to_stacked_layout
from repro_torch.tree import tree_map

_F16_MAX = float(np.finfo(np.float16).max)


class _Leaf:
    """A leaf's place in a flattened tree's structure.  One instance, also
    across a pickle round trip (an encoded update spilled to disk or
    checkpointed in flight): ``unflatten`` tests it by identity."""

    def __repr__(self) -> str:
        return "*"

    def __reduce__(self):
        return "_LEAF"


_LEAF = _Leaf()


def flatten(tree) -> Tuple[list, Any]:
    """(leaves, structure) in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order, ``None`` an empty subtree."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def unflatten(structure, leaves: list):
    it = iter(leaves)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(walk(v) for v in s)
        return next(it) if s is _LEAF else s

    return walk(structure)


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _is_float_array(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return hasattr(x, "dtype") and np.issubdtype(x.dtype, np.floating)


def trees_congruent(a, b) -> bool:
    """Same structure and the same leaf shapes — the congruence rule the
    comm layer uses everywhere (delta coding, error-feedback residual
    reuse, the delta downlink's compare)."""
    la, ta = flatten(a)
    lb, tb = flatten(b)
    return ta == tb and all(_shape(x) == _shape(y) for x, y in zip(la, lb))


def _host(x):
    # a copy: the wire never shares memory with the tensor it encodes
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return x


def to_wire(tree):
    """The port's tree -> the wire layout, numpy leaves."""
    return to_stacked_layout(tree_map(_host, tree))


def _device_of(tree) -> Optional[torch.device]:
    for leaf in flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def from_wire(tree, device: Optional[torch.device]):
    """The wire layout -> the port's tree, every array a tensor on
    ``device`` (numpy when ``device`` is None)."""
    tree = from_stacked_layout(tree)
    if device is None:
        return tree
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device) if isinstance(a, np.ndarray) else a, tree)


def wire_sums(stat: Callable, tree, *rest) -> list:
    """``stat(leaf, *congruent leaves)`` (a 1-D integer array) for every
    leaf of ``tree``, summed over each wire-layout leaf (a stacked layer
    leaf sums its layers'), in the wire layout's leaf order: per-leaf
    counts without copying the tree to the host."""
    return flatten(to_stacked_layout(
        tree_map(stat, tree, *rest), stack=lambda xs: np.sum(xs, axis=0)))[0]


def _size_stat(x) -> np.ndarray:
    """[elements, bytes, float leaves] of one leaf."""
    if isinstance(x, torch.Tensor):
        return np.array([x.numel(), x.numel() * x.element_size(),
                         x.is_floating_point()], np.int64)
    if hasattr(x, "dtype") and hasattr(x, "nbytes"):
        return np.array([x.size, x.nbytes, _is_float_array(x)], np.int64)
    return np.zeros(3, np.int64)


@dataclasses.dataclass
class WirePayload:
    """One encoded tree as it crosses the link.  ``nbytes`` is the exact
    wire size of the encoded representation; ``blobs`` holds one
    per-leaf record in the wire layout's leaf order (codec-private);
    ``treedef`` is (the wire layout's structure, the device to decode
    onto)."""
    codec: str
    blobs: List[tuple]
    treedef: Any
    nbytes: int


class Codec(Protocol):
    """Duck-typed codec protocol (subclassing :class:`TreeCodec` is the
    convenient way to satisfy it)."""
    name: str

    def encode(self, tree, mask=None) -> WirePayload: ...

    def decode(self, wp: WirePayload): ...

    def size_bytes(self, tree=None, *, n_coords: Optional[int] = None) -> int:
        ...


class TreeCodec:
    """Shared leaf-walking machinery: subclasses implement
    ``_encode_leaf(x_f32, mask_bool | None) -> (blob, nbytes)`` and
    ``_decode_leaf(blob) -> np.ndarray``."""

    name = "abstract"

    def encode(self, tree, mask=None) -> WirePayload:
        leaves, structure = flatten(to_wire(tree))
        mleaves = flatten(to_wire(mask))[0] if mask is not None \
            else [None] * len(leaves)
        blobs, nbytes = [], 0
        for x, m in zip(leaves, mleaves):
            if not _is_float_array(x):
                blobs.append(("raw", x))
                nbytes += int(getattr(x, "nbytes", 0))
                continue
            arr = np.asarray(x, np.float32)
            mb = None if m is None else np.asarray(m) > 0
            blob, b = self._encode_leaf(arr, mb)
            blobs.append(blob)
            nbytes += int(b)
        return WirePayload(self.name, blobs, (structure, _device_of(tree)),
                           int(nbytes))

    def decode(self, wp: WirePayload):
        leaves = [blob[1] if blob[0] == "raw" else self._decode_leaf(blob)
                  for blob in wp.blobs]
        structure, device = wp.treedef
        return from_wire(unflatten(structure, leaves), device)

    # ------------------------------------------------------------ accounting
    #: wire bytes per encoded coordinate (dense codecs); topk overrides
    #: size_bytes outright.
    coord_bytes = 4.0
    #: fixed per-leaf overhead (e.g. qsgd's fp32 scale).
    leaf_overhead = 0

    def size_bytes(self, tree=None, *, n_coords: Optional[int] = None) -> int:
        """Wire size without encoding (the codec half of
        ``fl.strategy.wire_bytes``).  ``n_coords`` overrides the active
        coordinate count (padded carriers); ``tree`` supplies the wire
        layout's leaf counts and sizes."""
        ns, raw = _leaf_sizes(tree)
        n = int(n_coords) if n_coords is not None else sum(ns)
        n_leaves = max(1, len(ns))
        return int(math.ceil(n * self.coord_bytes)
                   + n_leaves * self.leaf_overhead + raw)


def _leaf_sizes(tree) -> Tuple[List[int], int]:
    """(per-float-leaf element counts, raw bytes of non-float leaves), in
    the wire layout."""
    if tree is None:
        return [], 0
    ns, raw = [], 0
    for n, nbytes, floating in wire_sums(_size_stat, tree):
        if floating:
            ns.append(int(n))
        else:
            raw += int(nbytes)
    return ns, raw


def _scatter(vals, m, shape):
    out = np.zeros(shape, np.float32)
    out[m] = vals
    return out


class NoneCodec(TreeCodec):
    """Identity — raw float32 on the wire.  The engine short-circuits the
    whole channel for it, so ``codec="none"`` is the channel-free engine
    exactly."""

    name = "none"
    coord_bytes = 4.0

    def _encode_leaf(self, x, m):
        if m is None:
            return ("dense", x), x.nbytes
        vals = x[m]
        return ("masked", vals, m, x.shape), vals.nbytes

    def _decode_leaf(self, blob):
        if blob[0] == "dense":
            return blob[1]
        _, vals, m, shape = blob
        return _scatter(vals, m, shape)


class Fp16Codec(TreeCodec):
    """float16 cast (values clipped to +-65504): 2x compression,
    deterministic."""

    name = "fp16"
    coord_bytes = 2.0

    def _encode_leaf(self, x, m):
        vals = x if m is None else x[m]
        enc = np.clip(vals, -_F16_MAX, _F16_MAX).astype(np.float16)
        if m is None:
            return ("dense", enc), enc.nbytes
        return ("masked", enc, m, x.shape), enc.nbytes

    def _decode_leaf(self, blob):
        if blob[0] == "dense":
            return blob[1].astype(np.float32)
        _, enc, m, shape = blob
        return _scatter(enc.astype(np.float32), m, shape)


class QsgdInt8Codec(TreeCodec):
    """QSGD (Alistarh et al. 2017) stochastic uniform quantization to
    int8: per leaf, ``scale = max|x| / 127`` (one fp32 on the wire) and
    each coordinate rounds stochastically to a neighbouring level —
    unbiased in expectation over the codec's own seeded stream."""

    name = "qsgd_int8"
    coord_bytes = 1.0
    leaf_overhead = 4

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    # the stream is part of a resumed run's state (ROADMAP §3, fault 16)
    def export_state(self) -> dict:
        return self._rng.bit_generator.state

    def import_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    def _encode_leaf(self, x, m):
        vals = x if m is None else x[m]
        amax = float(np.max(np.abs(vals))) if vals.size else 0.0
        scale = amax / 127.0
        if scale == 0.0:
            q = np.zeros(vals.shape, np.int8)
        else:
            v = vals / scale
            lo = np.floor(v)
            q = np.clip(lo + (self._rng.random(vals.shape) < (v - lo)),
                        -127, 127).astype(np.int8)
        blob = ("q8", q, scale) if m is None \
            else ("q8m", q, scale, m, x.shape)
        return blob, q.nbytes + 4

    def _decode_leaf(self, blob):
        if blob[0] == "q8":
            return blob[1].astype(np.float32) * blob[2]
        _, q, scale, m, shape = blob
        return _scatter(q.astype(np.float32) * scale, m, shape)


class TopKCodec(TreeCodec):
    """Top-k magnitude sparsification: per leaf, keep the
    ``ceil(k_frac * n)`` largest-|value| coordinates (at least one) and
    ship (fp32 value, int32 flat index) pairs — 8 bytes a kept
    coordinate.  Biased; run it behind error feedback."""

    name = "topk"

    def __init__(self, k_frac: float = 0.1):
        if not 0.0 < k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")
        self.k_frac = float(k_frac)

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.k_frac * n)))

    def _encode_leaf(self, x, m):
        flat = x.ravel()
        cand = np.arange(flat.size) if m is None else np.flatnonzero(m.ravel())
        mag = np.abs(flat[cand])
        k = min(self._k(mag.size), mag.size) if mag.size else 0
        if k == 0:
            idx = np.zeros((0,), np.int32)
        elif k >= mag.size:
            idx = cand.astype(np.int32)
        else:
            idx = cand[np.argpartition(mag, mag.size - k)[mag.size - k:]]
            idx = np.sort(idx).astype(np.int32)
        vals = flat[idx].astype(np.float32)
        return ("topk", vals, idx, x.shape), vals.nbytes + idx.nbytes

    def _decode_leaf(self, blob):
        _, vals, idx, shape = blob
        out = np.zeros(int(np.prod(shape)), np.float32)
        out[idx] = vals
        return out.reshape(shape)

    def size_bytes(self, tree=None, *, n_coords: Optional[int] = None) -> int:
        ns, raw = _leaf_sizes(tree)
        if n_coords is not None or not ns:
            n = int(n_coords) if n_coords is not None else 0
            return 8 * self._k(n) + raw if n else raw
        return sum(8 * self._k(n) for n in ns) + raw


#: name -> zero-config factory.  ``register_codec`` extends it.
CODECS: Dict[str, Callable[[], Codec]] = {
    "none": NoneCodec,
    "fp16": Fp16Codec,
    "qsgd_int8": QsgdInt8Codec,
    "topk": TopKCodec,
}


def register_codec(name: str) -> Callable:
    """``@register_codec("mycodec")`` on a codec class or factory."""
    def deco(factory: Callable) -> Callable:
        if name in CODECS:
            raise ValueError(f"codec {name!r} already registered")
        CODECS[name] = factory
        return factory
    return deco


def get_codec(spec: Union[str, Codec, None]) -> Codec:
    """A codec knob: a registered name (default config), an already
    configured instance (as it is), or ``None`` -> "none"."""
    if spec is None:
        spec = "none"
    if not isinstance(spec, str):
        return spec
    if spec not in CODECS:
        raise KeyError(f"unknown codec {spec!r}; "
                       f"available: {sorted(CODECS)}")
    return CODECS[spec]()

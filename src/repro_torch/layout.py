"""The stacked layout of a parameter tree, and the port's own.

The port keeps a model's repeated layers as a Python list with one dict
per layer (``params["units"]``, ``params["layers"]``, ``params["blocks"]``,
...), and a ResNet's conv weights as OIHW.  The stacked layout keeps each
list as one leaf per path, stacked on a leading layer axis, and conv
weights as HWIO: the JAX reference's layout.  The wire codecs
(``fl.comm``) encode a tree in the stacked layout, so that a leaf's codec
state (qsgd's scale, topk's k, the delta downlink's cap) spans the same
coordinates as the reference's; ``testing.convert`` carries parameters
across to the reference through it.

A transformer's units cross as ``{"sub_0": ..., "sub_{m-1}": ...}``, m
its config's ``moe_every`` (a unit of one sublayer is that sublayer's
dict in the port); zamba2's ``mamba_groups`` (G lists of M layers) as
(G, M, ...) leaves; whisper's ``enc_layers`` / ``dec_layers`` and an
ssm LM's ``layers`` on one leading axis; a ViT's ``blocks`` (recognised
by ``"patch_embed"``) likewise.  Any other tree (a ResNet's) keeps its
structure, its 4-D leaves transposed.  Every other leaf crosses as it
is; a tuple or list of trees crosses tree by tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.tree import tree_leaves, tree_map


HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(layers: list, stack: Callable = np.stack) -> Any:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers], stack)
                for k in first}
    return stack(layers)


def _is_scalar(a) -> bool:
    return a is None or isinstance(a, (int, float))


def _ndim(a) -> int:
    return a.ndim if hasattr(a, "ndim") else np.ndim(a)


def conv_layout(tree: Any, axes: tuple) -> Any:
    """Transpose every 4-D leaf (a ResNet tree's conv weights) by
    ``axes``; copies, so the result shares no memory with ``tree``
    (Python scalars pass as they are)."""
    return tree_map(lambda a: a if _is_scalar(a)
                    else np.transpose(a, axes).copy() if np.ndim(a) == 4
                    else np.array(a), tree)


# the LM trees' keys stacked on a leading layer axis
_LAYER_KEYS = ("units", "layers", "enc_layers", "dec_layers",
               "mamba_groups")


def is_lm(tree: Dict[str, Any]) -> bool:
    return any(k in tree for k in _LAYER_KEYS)


def _unstack_all(stacked: Any) -> list:
    n = len(tree_leaves(stacked)[0])
    return [_unstack(stacked, i) for i in range(n)]


def is_vit(tree: Dict[str, Any]) -> bool:
    return "patch_embed" in tree


def from_stacked_layout(tree: Any) -> Any:
    """A tree in the stacked layout (numpy leaves) -> the port's
    layout, leaves still numpy: stacked layers as lists, HWIO conv
    weights as OIHW copies; tuples and lists tree by tree."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_stacked_layout(t) for t in tree)
    if not isinstance(tree, dict):
        return tree
    if is_vit(tree):
        n = len(tree_leaves(tree["blocks"])[0])
        return {**tree, "blocks": [_unstack(tree["blocks"], i)
                                   for i in range(n)]}
    if not is_lm(tree):
        return conv_layout(tree, HWIO_TO_OIHW)
    out = dict(tree)
    for key in _LAYER_KEYS:
        if key not in tree:
            continue
        stacked = tree[key]
        if key == "units" and set(stacked) == {"sub_0"}:
            stacked = stacked["sub_0"]
        out[key] = _unstack_all(stacked)
        if key == "mamba_groups":       # (G, M, ...): a list of lists
            out[key] = [_unstack_all(group) for group in out[key]]
    return out


def to_stacked_layout(tree: Any, *, stack: Callable = np.stack,
                      conv: Optional[Callable] = None) -> Any:
    """The port's layout -> the stacked layout, over any leaves: each list
    of layers (units, ssm layers, whisper's, zamba2's (G, M) groups,
    ViT blocks) becomes one leaf per path through ``stack``, a ResNet
    tree's 4-D leaves go through ``conv`` (default: OIHW -> HWIO numpy
    copies); other leaves pass as they are, tuples and lists tree by
    tree."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_stacked_layout(t, stack=stack, conv=conv)
                          for t in tree)
    if not isinstance(tree, dict):
        return tree
    if is_vit(tree):
        return {**tree, "blocks": _stack(tree["blocks"], stack)}
    if not is_lm(tree):
        conv = conv or (lambda a: np.transpose(a, OIHW_TO_HWIO).copy())
        return tree_map(lambda a: conv(a) if _ndim(a) == 4 else a, tree)
    out = dict(tree)
    for key in ("layers", "enc_layers", "dec_layers"):
        if key in tree:
            out[key] = _stack(tree[key], stack)
    if "units" in tree:
        stacked = _stack(tree["units"], stack)
        out["units"] = stacked if "sub_0" in stacked else {"sub_0": stacked}
    if "mamba_groups" in tree:
        out["mamba_groups"] = _stack([_stack(group, stack)
                                      for group in tree["mamba_groups"]],
                                     stack)
    return out

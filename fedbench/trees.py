"""Parameter trees (nested dicts and lists of tensors) as flat path maps.

Both sides of the comparison hold their parameters in the same nested
layout; a leaf is named by its path (``layers.3.in_proj``), so the
program's state and the reference's are matched leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch


def flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: leaf}`` of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def nest(flat: Dict[str, torch.Tensor]) -> Any:
    """The nested tree of a flat path map; a level whose keys are all
    digits becomes a list."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _lists(root)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def change_norms(after: Dict[str, torch.Tensor],
                 before: Dict[str, torch.Tensor],
                 keep: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, float]:
    """Per leaf, the norm of ``after - before`` (the difference in the
    leaves' dtype, summed in float64), read in one transfer.  With
    ``keep`` each leaf's difference is also put there, on the host."""
    paths: List[str] = sorted(before)
    norms = []
    for p in paths:
        d = after[p] - before[p]
        norms.append(torch.linalg.vector_norm(d, dtype=torch.float64))
        if keep is not None:
            keep[p] = d.to("cpu")
    return dict(zip(paths, torch.stack(norms).tolist()))


def diff_norms(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """Per leaf of ``b``, the norm of ``a - b`` (the difference in the
    leaves' dtype, summed in float64); infinite where ``a`` lacks the
    leaf or its shape differs."""
    out = {}
    for p, t in b.items():
        u = a.get(p)
        out[p] = math.inf if u is None or u.shape != t.shape else float(
            torch.linalg.vector_norm(u - t, dtype=torch.float64))
    return out

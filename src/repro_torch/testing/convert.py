"""Carry parameters across between the reference and the port.

The reference keeps a dense transformer as
``{"embed", "units": {"sub_0": {... leaves stacked on a leading layer
axis}}, "final_norm", "lm_head"}`` of arrays; the port keeps
``params["units"]`` as a list with one dict per layer.  Matrices keep the
reference's (in, out) layout on both sides (the port multiplies
``x @ w``), so nothing is transposed.  Arrays cross as numpy, so this
module needs neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves, tree_map


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(layers: list) -> Any:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers)


def params_from_reference(tree: Dict[str, Any], *,
                          device: DeviceLike = None,
                          dtype=torch.float32) -> Dict[str, Any]:
    """Reference parameter tree (numpy arrays) -> the port's tree of
    tensors on ``device`` (the GPU unless ``"cpu"``)."""
    dev = resolve_device(device)
    units = tree["units"]
    if set(units) != {"sub_0"}:
        raise NotImplementedError(
            f"only one sublayer per unit is ported, got {sorted(units)}")
    n = len(tree_leaves(units["sub_0"])[0])
    out = {k: v for k, v in tree.items() if k != "units"}
    out["units"] = [_unstack(units["sub_0"], i) for i in range(n)]
    return tree_map(lambda a: torch.tensor(np.array(a), dtype=dtype,
                                           device=dev), out)


def params_to_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree -> the reference's layout, as numpy arrays."""
    host = tree_map(lambda t: t.detach().cpu().numpy(), params)
    out = {k: v for k, v in host.items() if k != "units"}
    out["units"] = {"sub_0": _stack(host["units"])}
    return out


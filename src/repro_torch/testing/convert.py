"""Carry parameters across between the reference and the port.

The reference keeps a transformer (dense, MoE, VLM) as
``{"embed", "units": {"sub_0": ..., "sub_{m-1}": {... leaves stacked on a
leading unit axis}}, "final_norm", "lm_head"}`` of arrays, m the
config's ``moe_every``, and an ``ssm`` LM (mamba2, rwkv6) as ``{"embed",
"layers": {... stacked leaves}, "final_norm"[, "lm_head"]}``; the port
keeps ``params["units"]`` / ``params["layers"]`` as a list with one dict
per unit or layer: a unit of one sublayer is that sublayer's dict, a
unit of m > 1 is ``{"sub_0": ..., "sub_{m-1}": ...}`` (llama4's dense
layer, then its MoE layer).  A zamba2 tree stacks its mamba
layers as (G, M, ...) leaves under ``"mamba_groups"``; the port keeps a
list of G groups, each a list of M per-layer dicts.  A whisper tree
stacks ``"enc_layers"`` and ``"dec_layers"`` on a leading layer axis; the
port keeps a list each.  Every other leaf (``shared``,
``invocation_norms``, the positions, m-FeDepth's ``aux_norms``) crosses
as it is.  Matrices keep the
reference's (in, out) layout on both sides (the port multiplies
``x @ w``), so nothing is transposed.

A ViT tree, recognised by its ``"patch_embed"``, keeps the reference's
blocks stacked on a leading layer axis (``{"ln1": {"w": (L, d)}, "wqkv":
(L, d, 3d), ...}``); the port keeps ``params["blocks"]`` as a list with
one dict per layer.  Its other leaves cross as they are.

Any other tree (a ResNet's, recognised by having none of these keys, or
DepthFL's aux heads) keeps its structure: ``blocks`` is a list on both
sides, and ``classifier``, ``head_norm`` and m-FeDepth's ``aux_heads``
cross as they are.  Its conv weights, the only 4-D leaves, go from the
reference's HWIO to the port's OIHW and back.  A tuple or list of trees
crosses tree by tree: DepthFL's ``(params, aux)`` state and SplitMix's
list of base nets.

A decode cache (``cache_from_reference`` / ``cache_to_reference``) keeps
the reference's layout on both sides: a dict of leaves stacked on a
leading layer axis, each in the reference's dtype (zamba2's
``ssm_state`` / ``conv_state`` / ``k`` / ``v``, whisper's ``k`` / ``v``
and its unstacked ``enc_out`` too).  numpy has no bf16 of
its own, so a bf16 leaf crosses as float32 (exact) and ``dtypes`` names
the dtype to cast it back to.

The layers' stacking and the conv transpose are ``repro_torch.layout``'s,
which the wire codecs share.  Arrays cross as numpy, so this module needs
neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layout import (OIHW_TO_HWIO, conv_layout,
                                from_stacked_layout, is_lm, is_vit,
                                to_stacked_layout)
from repro_torch.tree import tree_map


def _tensors(tree: Any, dev, dtype) -> Any:
    return tree_map(lambda a: torch.tensor(np.array(a), dtype=dtype,
                                           device=dev), tree)


def params_from_reference(tree: Any, *, device: DeviceLike = None,
                          dtype=torch.float32) -> Any:
    """Reference parameter tree (numpy arrays) -> the port's tree of
    tensors on ``device`` (the GPU unless ``"cpu"``)."""
    dev = resolve_device(device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(t, device=dev, dtype=dtype)
                          for t in tree)
    return _tensors(from_stacked_layout(tree), dev, dtype)


def params_to_reference(params: Any) -> Any:
    """The port's tree -> the reference's layout, as numpy arrays."""
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_reference(t) for t in params)
    host = tree_map(lambda t: t.detach().cpu().numpy(), params)
    if not is_lm(host) and not is_vit(host):
        return conv_layout(host, OIHW_TO_HWIO)
    return to_stacked_layout(host)


def cache_from_reference(cache: Dict[str, Any], *, device: DeviceLike = None,
                         dtypes: Optional[Dict[str, torch.dtype]] = None
                         ) -> Dict[str, torch.Tensor]:
    """A reference decode cache (numpy arrays) -> tensors on ``device``
    (the GPU unless ``"cpu"``), each in ``dtypes[key]`` if given, else in
    the array's dtype."""
    dev = resolve_device(device)
    out = {}
    for k, a in cache.items():
        t = torch.tensor(np.array(a), device=dev)
        out[k] = t.to(dtypes[k]) if dtypes and k in dtypes else t
    return out


def cache_to_reference(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's decode cache -> numpy arrays in the same layout; bf16
    leaves as float32 (exact)."""
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
            for k, t in cache.items()}

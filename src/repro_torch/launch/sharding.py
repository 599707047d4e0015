"""Sharding rules: parameter / batch / cache specs per architecture (port
of ``repro.launch.sharding``).

Policy (the reference's DESIGN.md §5):
  * TP: weight matrices shard their "wide" dim on ``model``; MoE experts
    shard the expert dim on ``model`` (expert parallelism).
  * FSDP (big archs or ``fsdp=True``): the other contraction dim
    additionally shards on ``data`` so parameters and optimizer state fit
    the device (qwen3-moe 235B / llama4 400B).
  * ``pod`` is pure DP: parameters replicated across pods, batch sharded.
  * batch shards on ("pod", "data"); decode KV caches shard batch on
    ``data`` and the sequence dim on ``model``.

A spec is a plain tuple with one entry per dimension: a mesh axis name,
a tuple of axis names, or ``None`` (the reference's ``PartitionSpec``;
``()`` is replicated).  Rules are (regex over the leaf's path) -> spec
templates, resolved against the mesh's axis names and sizes.  The port
keeps a transformer's units (an ssm's layers, whisper's encoder and
decoder layers, zamba2's mamba groups) as lists of per-layer dicts, not
stacked on a leading axis: a leaf under such a list has no stacked dim,
so its spec is the reference's with the leading ``None``\\ s dropped.
Leaf paths are built as the reference's ``_map_with_path`` builds them
(keys and list positions joined by ``/``), so the regexes match the same
leaves.

:func:`to_named` turns specs into DTensor placements (one per mesh dim)
and :func:`distribute` lays a tree of tensors out on a
``torch.distributed`` ``DeviceMesh`` by them.  The rules read only a
mesh's ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import InputShape, ModelConfig

FSDP_THRESHOLD = 30e9  # params above this always shard on data too

Spec = Tuple


def needs_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > FSDP_THRESHOLD


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# --------------------------------------------------------------------------
# param rules
# --------------------------------------------------------------------------
def _rules(cfg: ModelConfig, fsdp: bool):
    """[(path_regex, spec_without_leading_stack_dims)].  Specs are given
    for the LAST dims of the leaf; leading stacked dims are padded with
    None."""
    d_axis = "data" if fsdp else None
    R = [
        # --- attention ---
        (r".*attn.*/wq$", (d_axis, "model")),
        (r".*attn.*/wk$", (d_axis, "model")),
        (r".*attn.*/wv$", (d_axis, "model")),
        (r".*attn.*/wo$", ("model", d_axis)),
        (r".*attn.*/b[qkv]$", ("model",)),
        # --- dense mlp ---
        (r".*mlp/w_gate$", (d_axis, "model")),
        (r".*mlp/w_up$", (d_axis, "model")),
        (r".*mlp/w_down$", ("model", d_axis)),
        (r".*/(w1|b1)$", (d_axis, "model")),
        (r".*/w2$", ("model", d_axis)),
        (r".*/b2$", (None,)),
        # --- moe: expert dim on model (EP); FSDP shards expert ffn dim ---
        (r".*moe/w_gate$", ("model", None, d_axis)),
        (r".*moe/w_up$", ("model", None, d_axis)),
        (r".*moe/w_down$", ("model", d_axis, None)),
        (r".*moe/router$", (None, None)),
        (r".*moe/shared_gate$", (d_axis, "model")),
        (r".*moe/shared_up$", (d_axis, "model")),
        (r".*moe/shared_down$", ("model", d_axis)),
        # --- rwkv time/channel mix ---
        (r".*/(wr|wk|wv|wg|wo)$", (d_axis, "model")),
        (r".*/mix_lora_a$", (d_axis, None)),
        (r".*/mix_lora_b$", (None, None, "model")),
        (r".*/w_lora_a$", (d_axis, None)),
        (r".*/w_lora_b$", (None, "model")),
        (r".*/cm_k$", (d_axis, "model")),
        (r".*/cm_v$", ("model", d_axis)),
        (r".*/cm_r$", (d_axis, "model")),
        (r".*/bonus_u$", (None, None)),
        # --- mamba ---
        (r".*/in_proj$", (d_axis, "model")),
        (r".*/out_proj$", ("model", d_axis)),
        (r".*/conv_w$", (None, "model")),
        (r".*/conv_b$", ("model",)),
        # --- embeddings / head ---
        (r"^embed$", ("model", d_axis)),
        (r"^(lm_head)$", (d_axis, "model")),
        (r"^(pos_dec|pos_enc|pos|cls)$", None),
        (r".*classifier/w$", (None, None)),
    ]
    return R


def _stack_depth(path: str, cfg: ModelConfig) -> int:
    """Number of leading stacked dims of this leaf.  The reference stacks
    units / layers / groups on leading axes; the port keeps them as
    lists, so only ``invocation_norms`` (zamba2's (groups, 2, d)) is
    stacked."""
    return 1 if path == "invocation_norms" else 0


def param_specs(cfg: ModelConfig, params_shape, mesh,
                fsdp: Optional[bool] = None) -> Any:
    """Spec tree matching ``params_shape`` (a tree of tensors, e.g. on the
    ``meta`` device from :func:`repro_torch.launch.steps.abstract_params`)."""
    fsdp = needs_fsdp(cfg) if fsdp is None else fsdp
    rules = _rules(cfg, fsdp)
    sizes = axis_sizes(mesh)

    def spec_for(path: str, leaf) -> Spec:
        nd = len(leaf.shape)
        stack = _stack_depth(path, cfg)
        for pat, tmpl in rules:
            if re.search(pat, path):
                if tmpl is None:
                    return ()
                tail = [a if (a in sizes) else None for a in tmpl]
                tail = tail[-(nd - stack):] if nd - stack else []
                spec = [None] * stack + list(tail)
                spec = spec[:nd] + [None] * (nd - len(spec))
                # drop axes that don't divide the dim
                out = []
                for dim, ax in zip(leaf.shape, spec):
                    if ax is None:
                        out.append(None)
                    else:
                        out.append(ax if dim % sizes[ax] == 0 else None)
                return tuple(out)
        return ()  # replicated default (norms, biases, scalars)

    return _map_with_path(spec_for, params_shape)


def _map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_map_with_path(fn, v, f"{prefix}{i}/")
               for i, v in enumerate(tree)]
        return type(tree)(seq) if not isinstance(tree, tuple) else tuple(seq)
    return fn(prefix[:-1], tree)


def map_specs(fn: Callable, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree: dicts and lists are
    containers, a tuple is a spec (a leaf); ``trees`` are congruent trees
    of tensors."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    return fn(specs, *trees)


def spec_leaves(specs) -> list:
    """The leaves of a spec (or placements) tree in ``tree_leaves``
    order: dict keys sorted, lists in order, a tuple a leaf."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


# --------------------------------------------------------------------------
# batch / cache rules
# --------------------------------------------------------------------------
def _batch_axis(sizes: Dict[str, int]):
    baxes = tuple(a for a in sizes if a in ("pod", "data"))
    return baxes if len(baxes) > 1 else (baxes[0] if baxes else None)


def _fits(sizes: Dict[str, int], dim_size: int, ax):
    if ax is None:
        return None
    sz = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
    return ax if dim_size % sz == 0 else None


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict:
    """Specs for the ``input_specs()`` dict."""
    sizes = axis_sizes(mesh)
    b = _batch_axis(sizes)

    def batch_leading(leaf_name: str, leaf):
        nd = len(leaf.shape)
        if leaf_name == "mrope_positions":
            return (None, _fits(sizes, leaf.shape[1], b), *([None] * (nd - 2)))
        if leaf_name == "cache_index":
            return ()
        return (_fits(sizes, leaf.shape[0], b), *([None] * (nd - 1)))

    from repro_torch.configs.shapes import input_specs
    specs = input_specs(cfg, shape)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_specs_sharding(cfg, v, mesh)
        else:
            out[k] = batch_leading(k, v)
    return out


def cache_specs_sharding(cfg: ModelConfig, cache: Dict, mesh) -> Dict:
    """Decode cache: batch on data axes, sequence dim on model."""
    sizes = axis_sizes(mesh)
    b = _batch_axis(sizes)
    m = "model" if "model" in sizes else None

    def spec(name, leaf):
        shp = leaf.shape

        def fits(dim_size, ax):
            return _fits(sizes, dim_size, ax)

        if name in ("k", "v"):            # (L, B, S, Hkv, hd)
            return (None, fits(shp[1], b), fits(shp[2], m), None, None)
        if name == "enc_out":             # (B, S, D)
            return (fits(shp[0], b), None, fits(shp[2], m))
        if name == "rwkv_state":          # (L, B, H, D, D)
            return (None, fits(shp[1], b), fits(shp[2], m), None, None)
        if name == "rwkv_shift":          # (L, 2, B, D)
            return (None, None, fits(shp[2], b), fits(shp[3], m))
        if name == "ssm_state":           # (L, B, nh, hd, N)
            return (None, fits(shp[1], b), fits(shp[2], m), None, None)
        if name == "conv_state":          # (L, B, K, din)
            return (None, fits(shp[1], b), None, fits(shp[3], m))
        return ()

    return {k: spec(k, v) for k, v in cache.items()}


def opt_state_specs(param_spec_tree):
    """Optimizer slots mirror their parameter's sharding."""
    return param_spec_tree


# --------------------------------------------------------------------------
# specs -> DTensor placements
# --------------------------------------------------------------------------
def placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` on the mesh dims
    that tensor dim d names (a tuple of names shards d over several mesh
    dims, in mesh order, as a ``PartitionSpec`` does), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def to_named(tree_specs, mesh):
    """The spec tree as a tree of placement tuples on ``mesh``."""
    return map_specs(lambda s: placements(s, mesh), tree_specs)


def distribute(tree, tree_specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh``, laid out by
    ``tree_specs`` (each rank keeps its own shard; gradients off).  The
    shards are copies: ``distribute_tensor`` would keep a replicated
    tensor itself, and the in-place steps would then write the caller's
    tree."""
    from torch.distributed.tensor import distribute_tensor

    def one(spec, t):
        return distribute_tensor(t.detach().clone(), mesh,
                                 placements(spec, mesh))
    return map_specs(one, tree_specs, tree)

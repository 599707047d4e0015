"""Checkpointing: parameter tree <-> ``.npz`` with a structure manifest
(port of ``repro.train.checkpoint``, over the port's trees of tensors).

The file layout is the reference's, so either side loads the other's
files: one array per leaf under its path (dict keys sorted, list and
tuple items as ``#i``, joined by ``::``), a JSON ``__manifest__`` with
the structure (tuples and lists tagged) and the metadata, and a bf16
leaf stored as float32 beside a ``__dtype__::<path>`` tag (npz has no
bf16).  Tensors go to host numpy to be written; :func:`load` restores
them on a device (the GPU unless the caller asks for ``"cpu"``), bf16
leaves in bf16.  Round-based retention for
FL keeps the last K rounds.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_SEP = "::"
_BF16 = b"bfloat16"


def _host(leaf, key: str) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype == object:
        raise TypeError(f"checkpoint leaf {key!r} is no array: "
                        f"{type(leaf).__name__}")
    return arr


def _flatten(tree, prefix=""):
    """npz can't store bfloat16 — save as float32 + dtype tag."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        key = prefix[:-len(_SEP)]
        out[key] = _host(tree, key)
        if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
            out[f"__dtype__{_SEP}{key}"] = np.frombuffer(_BF16,
                                                         dtype=np.uint8)
    return out


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return ["__tuple__"] + [_structure(v) for v in tree]
    if isinstance(tree, list):
        return ["__list__"] + [_structure(v) for v in tree]
    return None


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Atomic: writes a tmp file in the target directory and
    ``os.replace``s it into place, so a crash mid-write can never leave
    a truncated ``.npz`` under the final name."""
    if not path.endswith(".npz"):
        path = path + ".npz"           # np.savez appends it to bare paths
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    manifest = {"structure": _structure(tree), "metadata": metadata or {}}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=np.frombuffer(
                json.dumps(manifest).encode(), dtype=np.uint8), **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(path: str, *, device: DeviceLike = None,
         dtype: Optional[torch.dtype] = None):
    """Returns (tree, metadata): every leaf a tensor on ``device`` (the
    GPU unless ``"cpu"`` is asked for; raises when the GPU is implied and
    there is none), in its stored dtype (a tagged leaf in bf16), or every
    floating leaf in ``dtype`` when one is given."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        tag = f"__dtype__{_SEP}"
        dtags = {k[len(tag):] for k in data.files if k.startswith(tag)}
        flat = {k: data[k] for k in data.files
                if k != "__manifest__" and not k.startswith(tag)}

    def leaf(key: str) -> torch.Tensor:
        t = torch.from_numpy(np.array(flat[key])).to(device)
        if key in dtags:
            t = t.to(torch.bfloat16)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def rebuild(struct, prefix=""):
        if isinstance(struct, dict):
            return {k: rebuild(v, f"{prefix}{k}{_SEP}")
                    for k, v in struct.items()}
        if isinstance(struct, list):
            tag_, items = struct[0], struct[1:]
            seq = [rebuild(v, f"{prefix}#{i}{_SEP}")
                   for i, v in enumerate(items)]
            return tuple(seq) if tag_ == "__tuple__" else seq
        return leaf(prefix[:-len(_SEP)])

    return rebuild(manifest["structure"]), manifest["metadata"]


def save_round(ckpt_dir: str, round_idx: int, tree: Any,
               metadata: Optional[dict] = None, keep: int = 3) -> str:
    path = os.path.join(ckpt_dir, f"round_{round_idx:06d}.npz")
    save(path, tree, {**(metadata or {}), "round": round_idx})
    _gc(ckpt_dir, keep)
    return path


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = sorted(f for f in os.listdir(ckpt_dir)
                    if re.fullmatch(r"round_\d+\.npz", f))
    return os.path.join(ckpt_dir, rounds[-1]) if rounds else None


def load_latest(ckpt_dir: str, *, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None):
    """Newest loadable round checkpoint: ``(path, tree, metadata)`` or
    ``None``, on ``device`` as :func:`load` puts it.  A corrupt / partial
    ``.npz`` is skipped with a warning and the previous retained round is
    used instead of failing the resume."""
    device = resolve_device(device)
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = sorted((f for f in os.listdir(ckpt_dir)
                     if re.fullmatch(r"round_\d+\.npz", f)), reverse=True)
    for f in rounds:
        path = os.path.join(ckpt_dir, f)
        try:
            tree, metadata = load(path, device=device, dtype=dtype)
            return path, tree, metadata
        except Exception as e:
            warnings.warn(f"skipping corrupt checkpoint {path}: {e}")
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    rounds = sorted(f for f in os.listdir(ckpt_dir)
                    if re.fullmatch(r"round_\d+\.npz", f))
    for f in rounds[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))

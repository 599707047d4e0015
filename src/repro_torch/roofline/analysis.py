"""Roofline terms from the dry run's per-device counts (port of
``repro.roofline.analysis``).

  compute    = FLOPs per device / peak
  memory     = bytes per device / HBM bandwidth
  collective = collective bytes per device / NVLink bandwidth

The reference reads these from a compiled XLA artefact: ``cost_analysis``
of the partitioned (per-device) module, and ``collective_bytes``, which
parses the compiled HLO text for the result-shape bytes of every
collective.  Eager PyTorch has no compiled module and no HLO: the dry run
(``launch/dryrun.py``) runs one step on ``meta`` DTensors under
:class:`DeviceCounts`, a dispatch mode that sees each op as one device
runs it, after DTensor's sharding propagation (local shapes), and counts

  * FLOPs by ``torch.utils.flop_counter``'s formulas (those of
    ``FlopCounterMode``), on the local shapes;
  * bytes: every input read once and every output written once, per op
    (eager ops are not fused, so this is above what XLA's fused module
    accesses; views and allocations move nothing);
  * collective bytes: the result-shape bytes of every collective op
    (``_c10d_functional`` and ``c10d``), by kind, the role of
    ``collective_bytes(hlo_text)``.

``FlopCounterMode`` itself, entered around DTensors, counts each op at its
global shape (a (4096, 4096) @ (4096, 11008) product split 16 x 16 reads
3.69e11 FLOPs, the whole product); the counts here come from the local
shapes instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline import hw

# collective op names (``_c10d_functional`` / ``c10d``) -> the reference's
# HLO kinds
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "collective-permute"), ("send", "collective-permute"),
          ("recv", "collective-permute"))
# ops that allocate without moving data
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "_to_copy_meta")


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    name = func.__name__.split(".")[0]
    if name in ("wait_tensor", "_wrap_tensor_autograd"):
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class DeviceCounts(TorchDispatchMode):
    """Counts what one device runs under it: ``flops``, ``bytes`` and
    ``collectives`` ({kind: result bytes}).  A DTensor op is handed back
    (``NotImplemented``): DTensor propagates its sharding and runs the
    local op, which comes back here on plain tensors.  The ops DTensor
    runs on fake tensors to derive global shapes are not counted.  With
    ``host_ops=False`` (the dry run, whose device tensors are ``meta``)
    neither is an op whose tensors all lie on the CPU: DTensor's
    bookkeeping of shard sizes and offsets, which its first propagation
    of an op runs and a cached one skips."""

    def __init__(self, host_ops: bool = True):
        super().__init__()
        self.host_ops = host_ops
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's shape propagation
        if not self.host_ops and all(t.device.type == "cpu"
                                     for t in ins + outs):
            return out          # DTensor's host bookkeeping
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) \
                + _nbytes(outs)
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        name = func.__name__.split(".")[0]
        if not func.is_view and name not in _FREE:
            self.bytes += _nbytes(ins) + _nbytes(outs)
        return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives_by_kind: Dict[str, int]
    model_flops: float               # 6*N(active)*tokens, whole step
    peak_hbm_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        """At the BF16 tensor-core peak: the dry run's parameters are the
        reference's bf16."""
        return self.flops_per_device / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / hw.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives_by_kind": self.collectives_by_kind,
            "model_flops": self.model_flops,
            "peak_hbm_per_device": self.peak_hbm_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for train (fwd+bwd), 2*N*D for inference."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def analyze(counts: dict, cfg, shape, mesh_name: str, chips: int,
            arch: str, peak_hbm: Optional[float] = None) -> Roofline:
    """A :class:`Roofline` from the dry run's counts ({"flops", "bytes",
    "collectives": {kind: bytes}}, per device)."""
    colls = dict(counts.get("collectives", {}))
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=float(counts.get("flops", 0.0)),
        bytes_per_device=float(counts.get("bytes", 0.0)),
        collective_bytes_per_device=float(sum(colls.values())),
        collectives_by_kind=colls,
        model_flops=model_flops_for(cfg, shape),
        peak_hbm_per_device=peak_hbm)

"""Device meshes (port of ``repro.launch.mesh``).

The production meshes are ``torch.distributed`` ``DeviceMesh``\\ es with
the reference's axis names over the default process group, one rank a
device: a single pod is 16 x 16 = 256 ranks, axes ("data", "model");
multi-pod is 2 x 16 x 16 = 512, axes ("pod", "data", "model"), the
"pod" axis pure data parallelism.  The caller starts the process group
(``torch.distributed.init_process_group``, ``nccl`` on the cards,
``gloo`` on the CPU, ``"fake"`` for the dry run) before building one.

``make_data_mesh`` is the client fan-out axis of
``fl.scale.executor.ShardedScheduler``: a list of devices driven from one
process, no process group.

The reference's ``force_host_device_count`` is an XLA flag (N CPU devices
in one process) with no torch meaning: a mesh of N devices is N
processes.  Its role, many ranks on one host for tests, is
``repro_torch.testing.dist.spawn``'s.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16 x 16 ("data", "model") mesh, or 2 x 16 x 16 ("pod", "data",
    "model"), over a world of 256 / 512 ranks of ``device_type`` (the
    GPUs unless ``"cpu"``; the dry run's fake world needs no card)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda"):
    """A ("data", "model") mesh over every rank of the process group:
    ``model_axis`` ranks on "model", the rest on "data"; ranks of
    ``device_type`` (the GPUs unless ``"cpu"``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    data = max(1, n // model_axis)
    return init_device_mesh(device_type, (data, model_axis),
                            mesh_dim_names=("data", "model"))


def make_data_mesh(device: DeviceLike = None) -> List[torch.device]:
    """The ``"data"`` axis as a list of devices: every visible CUDA device
    (raises when there is none), or ``[device]`` when the caller names
    one (``"cpu"`` on a host without a card)."""
    dev = resolve_device(device)
    if device is not None or dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))

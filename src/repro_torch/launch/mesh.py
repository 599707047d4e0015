"""The client fan-out axis (port of ``repro.launch.mesh.make_data_mesh``).

The reference builds a 1-D ``"data"`` mesh over every visible device, the
axis ``fl.scale.executor.ShardedScheduler`` splits cohort groups over.
The port's counterpart is the list of those devices: the sharded
scheduler runs one chunk of a group on each, from one process.  The
reference's production and host meshes and ``force_host_device_count``
are XLA / TPU notions with no counterpart here (ROADMAP item 11).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.device import DeviceLike, resolve_device


def make_data_mesh(device: DeviceLike = None) -> List[torch.device]:
    """The ``"data"`` axis as a list of devices: every visible CUDA device
    (raises when there is none), or ``[device]`` when the caller names
    one (``"cpu"`` on a host without a card)."""
    dev = resolve_device(device)
    if device is not None or dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

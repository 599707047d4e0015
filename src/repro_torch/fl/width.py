"""Width-slimming utilities (port of ``repro.fl.width``): what FedAvg at
the cohort's lowest common width needs.  The prefix-channel slicing of
HeteroFL / SplitMix waits for their slice."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.preresnet20 import ResNetConfig


def subnet_config(cfg_full: ResNetConfig, ratio: float) -> ResNetConfig:
    return dataclasses.replace(cfg_full, width_ratio=ratio,
                               name=f"{cfg_full.name}-x{ratio:g}")

"""PreResNet-20 — the paper's own FL experiment model (He et al. 2016b);
the port's own copy of ``repro.configs.preresnet20``.

Width-scalable (``width_ratio`` scales the base channel counts for the
x r subnetwork baselines) and depth-decomposable (FeDepth): a stem, nine
two-conv residual blocks and a head.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "preresnet-20"
    source: str = "He et al. 2016b; paper Table 1"
    num_classes: int = 10
    stage_blocks: Tuple[int, int, int] = (3, 3, 3)   # 9 blocks x 2 conv = 18 + stem + head
    base_widths: Tuple[int, int, int] = (16, 32, 64)
    width_ratio: float = 1.0
    image_size: int = 32
    in_channels: int = 3

    def widths(self) -> Tuple[int, int, int]:
        return tuple(max(1, int(round(w * self.width_ratio)))
                     for w in self.base_widths)

    @property
    def num_blocks(self) -> int:
        return sum(self.stage_blocks)


CONFIG = ResNetConfig()


def scaled(ratio: float, num_classes: int = 10) -> ResNetConfig:
    return dataclasses.replace(CONFIG, width_ratio=ratio, num_classes=num_classes,
                               name=f"preresnet-20-x{ratio:g}")


def reduced(num_classes: int = 10, image_size: int = 16) -> ResNetConfig:
    return dataclasses.replace(
        CONFIG, stage_blocks=(1, 1, 1), base_widths=(8, 16, 32),
        num_classes=num_classes, image_size=image_size,
        name="preresnet-8-reduced")

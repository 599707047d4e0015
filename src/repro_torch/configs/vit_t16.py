"""ViT-T/16 — the paper's depth-wise fine-tuning model (Qu et al. 2022);
the port's own copy of ``repro.configs.vit_t16``.

Width-scalable (``width_ratio`` scales d_model and d_ff for the FedAvg
x1/6 baseline of paper Fig. 7) and depth-decomposable: a patch embedding,
``num_layers`` identical encoder blocks and a classification head.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "vit-t16"
    source: str = "Dosovitskiy et al. 2020; Qu et al. 2022"
    num_layers: int = 12
    d_model: int = 192
    num_heads: int = 3
    d_ff: int = 768
    patch_size: int = 16
    image_size: int = 32    # CIFAR-resolution fine-tuning
    num_classes: int = 10
    in_channels: int = 3
    width_ratio: float = 1.0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CONFIG = ViTConfig()


def reduced(num_classes: int = 10) -> ViTConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=2, d_ff=128,
        patch_size=4, image_size=16, num_classes=num_classes,
        name="vit-reduced")

"""Yi-6B — llama-architecture dense decoder with GQA. [arXiv:2403.04652]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512)

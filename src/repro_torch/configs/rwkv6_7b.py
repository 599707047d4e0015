"""RWKV-6 (Finch) 7B — attention-free RNN with data-dependent decay.
[arXiv:2404.05892]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=2, d_model=128, d_ff=256,
        vocab_size=512, rwkv_head_dim=32)

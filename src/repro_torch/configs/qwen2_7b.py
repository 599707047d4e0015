"""Qwen2-7B — dense GQA decoder with QKV bias. [arXiv:2407.10671]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512)

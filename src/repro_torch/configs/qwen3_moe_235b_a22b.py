"""Qwen3-MoE — 128 experts, top-8 routing, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B family, scaled per assignment]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,          # per-expert hidden size
    vocab_size=151936,
    head_dim=128,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=32, num_experts=4,
        experts_per_token=2)

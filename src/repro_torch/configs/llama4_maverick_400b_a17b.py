"""Llama-4 Maverick — MoE 128 experts top-1 + shared expert, MoE layers
interleaved with dense ones.
[hf:meta-llama/Llama-4-Scout-17B-16E family, scaled per assignment]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,          # per-expert hidden size
    vocab_size=202048,
    head_dim=128,
    num_experts=128,
    experts_per_token=1,
    num_shared_experts=1,
    moe_every=2,          # a unit: one dense layer, then one MoE layer
    dense_d_ff=16384,
    rope_theta=500_000.0,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=32, num_experts=4,
        experts_per_token=1, num_shared_experts=1)

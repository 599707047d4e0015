"""Zamba2-1.2B — Mamba2 backbone with a shared attention block.
[arXiv:2411.15242]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_num_heads=64,        # (2*2048)/64
    hybrid_attn_every=6,     # shared attention block every 6 layers
    shared_attention=True,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, ssm_state_dim=16,
        ssm_head_dim=32, ssm_num_heads=8, hybrid_attn_every=2)

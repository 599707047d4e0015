"""Qwen2-VL-2B — the VLM's language backbone with M-RoPE; the vision
tower is stubbed by ``frontend_embed_tokens`` embeddings prepended to the
text.  [arXiv:2409.12191]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    # temporal / height / width rotary sections of head_dim 128's 64
    # frequencies
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-6,
    frontend_embed_tokens=256,    # stubbed vision patches prepended
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, mrope_sections=(4, 6, 6),
        frontend_embed_tokens=16)

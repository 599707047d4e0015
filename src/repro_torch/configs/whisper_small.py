"""Whisper-small — encoder-decoder audio transformer backbone; the
mel-spectrogram + conv frontend is a stub providing frame embeddings.
[arXiv:2212.04356]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    is_encoder_decoder=True,
    max_source_positions=1500,  # 30 s of audio at 50 frames/s after the stub
    tie_embeddings=True,
    norm_eps=1e-5,
    # the original caps decoder positions at 448; the learned table is
    # extended to cover the 32k input shapes, as in the reference
    max_seq_len=32_768,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=2, encoder_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        max_source_positions=64)

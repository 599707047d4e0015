"""MiniCPM-2B — llama-like dense decoder trained with a WSD schedule.
[arXiv:2404.06395]  (MHA: kv_heads == heads; the head is tied.)"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    norm_eps=1e-5,
)

# MiniCPM's warmup-stable-decay learning-rate schedule, as fractions of
# the run
WSD_SCHEDULE = dict(warmup_frac=0.01, stable_frac=0.89, decay_frac=0.10)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, head_dim=0, num_layers=2, d_model=144, num_heads=4,
        num_kv_heads=4, d_ff=288, vocab_size=512)

"""Mamba2 370m — pure SSD-scan LM (the zamba2 mamba layer as a full
stack).  Ties the embedding and output head like the released
checkpoints, which makes its FeDepth prefix unstable (head updates reach
the embedding that feeds the frozen prefix).  [arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    ssm_kind="mamba2",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    d_ff=0,               # no FFN: the SSD block is the whole layer
    vocab_size=50288,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_num_heads=32,     # d_inner // head_dim = 2*1024 // 64
    ssm_expand=2,
    tie_embeddings=True,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, vocab_size=512,
        ssm_state_dim=16, ssm_head_dim=32, ssm_num_heads=8)

"""Tiny cells on the CPU for the benchmark's own tests: the real cells'
traffic and limits at a size a test run holds (the program's kernels
take their plain versions on the CPU)."""
from __future__ import annotations

import types

from fedbench import cells

CONFIGS = {
    "mamba2": dict(
        name="tiny-mamba2", reference="mamba2", family="ssm",
        ssm_kind="mamba2", num_layers=4, d_model=32, vocab_size=64,
        ssm_state_dim=8, ssm_head_dim=8, ssm_num_heads=8, ssm_expand=2,
        tie_embeddings=True, norm_eps=1e-5, num_heads=0, num_kv_heads=0,
        d_ff=0, head_dim=0),
    "dense": dict(
        name="tiny-dense", reference="dense", family="dense", num_layers=4,
        d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=64, qkv_bias=True, tie_embeddings=False,
        rope_theta=1e6, norm_eps=1e-6),
}
# the real cell whose traffic each tiny one takes
REAL = {"mamba2": "mamba2-fedepth-seq", "dense": "qwen2-fedepth-seq"}
# the limits of every tiny cell: the tightest cell's (a tiny model's
# rounding drifts less than a full one's, and so does the control's)
LIMITS = "qwen2-fedepth-seq"


def cell(kind: str, **traffic) -> cells.Cell:
    """The tiny ``kind`` model under its real cell's traffic, cut to
    batches of 2 x 16 tokens, held to ``LIMITS``' limits."""
    real = cells.load_cell(REAL[kind])
    cfg = types.SimpleNamespace(**CONFIGS[kind])
    tr = dict(real.traffic, batch_size=2, seq_len=16, pool_rounds=8)
    tr.update(traffic)
    return real._replace(name=f"tiny-{kind}", config=cfg, traffic=tr,
                         workload=cells.load_cell(LIMITS).workload,
                         family=cells.family(cfg), per_layer=[])

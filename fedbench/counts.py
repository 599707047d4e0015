"""The work of the timed path, counted from shapes: each kernel call's
operations and bytes, and a round's useful FLOPs.

The peaks are stated once.  ``PEAK_FLOPS`` is three TF32 products at
the H100 SXM's 495 TFLOP/s: the fastest rate at which the card makes an
fp32-accurate product, which is the precision the configurations state
(the program computes in fp32 with TF32 off; K1 and K2 split each
product into three TF32 ones).  No kernel that keeps fp32 accuracy can
run above it (cuBLAS fp32 on the CUDA cores tops out at 67 TFLOP/s,
the data sheet's figure).  Bytes count each input read once and each
output written once, whatever a kernel reads again.

Which cell each count describes:

* ``k1_call``: K1 (``csrc/chunked_ce.cu``), the head's cross-entropy of
  one block step: N = batch x seq rows against a (D, V) head.  Every
  cell (mamba2-370m's tied head, qwen2-7b's untied one).
* ``k2_call``: K2 (``csrc/flash_attention.cu``), one causal GQA
  attention forward of a batch: the dense cells (qwen2-7b).
* ``k3_call``: K3 (``csrc/mamba2_ssd.cu``), one SSD scan forward of a
  batch from a zero state: the mamba2 cells.
* ``round_flops``: a round's useful FLOPs, what FeDepth's algorithm
  needs: per subproblem and batch the frozen prefix's forward once
  (from scratch where the model ties its head, advanced through the
  just-trained units otherwise), and per step the trained units' and
  the head's forward and backward (the backward twice the forward); no
  recompute of rematerialized units and no evaluation.  Every cell.
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = 165e12          # FLOP/s: 495 TFLOP/s of TF32 / 3 products
PEAK_BYTES = 3.35e12         # bytes/s: HBM3, H100 SXM


class Work(NamedTuple):
    flops: float
    nbytes: float

    def bound_s(self) -> float:
        """The least time: operations at ``PEAK_FLOPS`` or bytes at
        ``PEAK_BYTES``, whichever is longer."""
        return max(self.flops / PEAK_FLOPS, self.nbytes / PEAK_BYTES)


def k1_call(N: int, D: int, V: int) -> Work:
    """Mean NLL of ``h @ W`` over N rows: the (N, D) x (D, V) product;
    reads h, W and the int32 labels, writes the per-row NLL and the
    mean."""
    return Work(2.0 * N * D * V, 4.0 * (N * D + D * V) + 8.0 * N + 4.0)


def k2_call(B: int, T: int, Hq: int, Hkv: int, hd: int) -> Work:
    """Causal attention: 4 hd FLOPs a live (q, k) pair and q head (the
    scores and the weighted sum); reads q, k, v, writes the output."""
    pairs = T * (T + 1) // 2
    return Work(4.0 * hd * pairs * B * Hq,
                4.0 * (2 * B * T * Hq * hd + 2 * B * T * Hkv * hd))


def k3_call(B: int, T: int, H: int, P: int, N: int) -> Work:
    """The SSD recurrence: per (b, t, h) 5 FLOPs a state element (decay
    and input into the state, then the state into y) and 3 a channel
    (dt x, D x, the sum); reads x, dt, B, C, A, D and the state, writes
    y and the state."""
    flops = 5.0 * B * T * H * P * N + 3.0 * B * T * H * P
    nbytes = 4.0 * (2 * B * T * H * P + B * T * H + 2 * B * T * N + 2 * H
                    + 2 * B * H * P * N)
    return Work(flops, nbytes)


def kernel_calls(cfg, traffic: dict) -> dict:
    """The work of one call of each kernel the cell launches, at the
    cell's shapes (every launch of a kernel in a cell has the same)."""
    B, T = traffic["batch_size"], traffic["seq_len"]
    out = {"k1": k1_call(B * T, cfg.d_model, cfg.vocab_size)}
    if getattr(cfg, "num_heads", 0):
        hd = cfg.head_dim or cfg.d_model // cfg.num_heads
        out["k2"] = k2_call(B, T, cfg.num_heads, cfg.num_kv_heads, hd)
    if getattr(cfg, "ssm_kind", "") == "mamba2":
        out["k3"] = k3_call(B, T, cfg.ssm_num_heads, cfg.ssm_head_dim,
                            cfg.ssm_state_dim)
    return out


def head_flops(cfg, n_tokens: int) -> float:
    """The head's forward: the logits' product (the norm is minor)."""
    return 2.0 * n_tokens * cfg.d_model * cfg.vocab_size


def step_flops(fam, cfg, traffic: dict, lo: int, hi: int) -> float:
    """One SGD step of subproblem [lo, hi) on one batch: the units' and
    the head's forward and backward."""
    B, T = traffic["batch_size"], traffic["seq_len"]
    fwd = (hi - lo) * fam.unit_flops(cfg, B, T) + head_flops(cfg, B * T)
    return 3.0 * fwd


def round_flops(fam, cfg, traffic: dict, decomps) -> float:
    """A round's useful FLOPs over every client's decomposition."""
    B, T = traffic["batch_size"], traffic["seq_len"]
    unit = fam.unit_flops(cfg, B, T)
    nb, steps = traffic["batches_per_client"], traffic["local_steps"]
    stable = fam.prefix_stable(cfg)
    total = 0.0
    for dec in decomps:
        done = 0                     # prefix units already buffered
        for lo, hi in dec.blocks:
            prefix = lo - done if stable else lo
            done = lo
            total += nb * prefix * unit
            total += nb * steps * step_flops(fam, cfg, traffic, lo, hi)
    return total

"""Analytic training-memory model — what the paper's decomposition runs on.

The paper's observation (Fig. 1, Table 1): *activations*, not parameters,
dominate training memory, so memory-aware decomposition must price each
depth unit by its activation footprint at the client's batch size, not by
its parameter count (the mistake HeteroFL/SplitMix make).

``unit_costs(...)`` returns an ordered list of ``UnitCost`` — one per
finest-decomposition depth unit, plus entries for the input embed/stem and
the head — from which the decomposer builds blocks and the FL simulator
prices client budgets.  All formulas are dtype-aware element counts * byte
width; they are validated against the paper's Table 1 depth-vs-width
relation in tests/benchmarks.

The port's own copy of ``repro.core.memory_model`` for the transformer
families (``lm_memory`` and its types; pure Python, the formulas
unchanged — tests/test_torch_core.py holds it to the reference on every
architecture).  The ResNet and ViT pricing wait for their slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class UnitCost:
    """Memory prices (bytes) for one depth unit."""
    name: str
    params: int         # parameter bytes
    activations: int    # forward activations that must be held for backward
    output: int         # size of the unit's output z_j (the buffer FeDepth
                        # keeps when training unit j+1)
    flops: int = 0      # PER-SAMPLE forward FLOPs (multiply-add = 2); the
                        # systime latency model prices backward as 2x

    def train_bytes(self, optimizer_slots: int = 2) -> int:
        """Bytes to TRAIN this unit alone: params + grads + optimizer
        state (slots * params, e.g. 2 for SGD-momentum in fp32 master +
        momentum) + its live activations."""
        return self.params * (2 + optimizer_slots) + self.activations


@dataclasses.dataclass(frozen=True)
class ModelMemory:
    units: List[UnitCost]          # depth units (finest decomposition)
    embed: UnitCost                # input side (embed/stem) — trained with unit 0
    head: UnitCost                 # classifier φ — trained with EVERY block
    batch: int = 1                 # batch size the activation bytes were
                                   # priced at (latency models rescale)

    def buffered_z_bytes(self, lo: int, *, n_batches: int = 1,
                         batch_size: Optional[int] = None) -> int:
        """Bytes of the buffered prefix activation z_{lo-1} held while a
        block starting at ``lo`` trains: the producing unit's ``output``
        (the embed/stem output for ``lo == 0``), one buffer per distinct
        local batch (``core.blockwise.PrefixCache`` keeps all of them so
        every SGD step reuses its batch's buffer), rescaled from the
        pricing batch to ``batch_size`` when given.

        This is THE buffered-z accounting: the runtime cache's
        ``buffered_bytes()``, the budget check (via
        :meth:`block_train_bytes`), and the systime latency model all
        price this same quantity — asserted in tests/test_prefix_cache.py.
        """
        out = self.embed.output if lo == 0 else self.units[lo - 1].output
        if batch_size is not None:
            out = out * batch_size // max(1, self.batch)
        return int(out) * max(0, n_batches)   # 0 buffers -> 0 bytes

    def block_train_bytes(self, lo: int, hi: int, *,
                          optimizer_slots: int = 2,
                          include_embed: bool = None,
                          n_batches: int = 1) -> int:
        """Memory to train contiguous units [lo, hi) + the head.

        ``n_batches`` counts the distinct local batches whose z_{lo-1}
        the prefix cache buffers simultaneously: each unit's
        ``activations`` already includes its input activation — which
        doubles as ONE buffered z_{lo-1} — so only the additional
        ``n_batches - 1`` buffers are added (``n_batches=1``, the paper's
        single-batch accounting, is unchanged)."""
        include_embed = (lo == 0) if include_embed is None else include_embed
        b = sum(u.train_bytes(optimizer_slots) for u in self.units[lo:hi])
        b += self.head.train_bytes(optimizer_slots)
        if include_embed:
            b += self.embed.train_bytes(optimizer_slots)
        b += self.buffered_z_bytes(lo, n_batches=n_batches - 1)
        return b

    def full_train_bytes(self, optimizer_slots: int = 2) -> int:
        """Standard end-to-end training (what FeDepth avoids)."""
        return (self.embed.train_bytes(optimizer_slots)
                + sum(u.train_bytes(optimizer_slots) for u in self.units)
                + self.head.train_bytes(optimizer_slots))

    def param_bytes(self) -> int:
        """Total parameter bytes (embed + units + head) — the frozen
        full-model argument every block step carries alongside its
        trained slice."""
        return (self.embed.params + self.head.params
                + sum(u.params for u in self.units))

    def rescaled(self, batch: int) -> "ModelMemory":
        """This model priced at a different batch size: parameter bytes
        are batch-invariant, activation/output bytes scale linearly.
        The engines price budgets at ``sim.mem_batch`` while training
        runs at ``sim.batch_size`` — the memory auditor uses this to
        compare XLA's measured footprint against the prediction at the
        batch size that actually compiled."""
        if batch == self.batch:
            return self

        def scale(u: UnitCost) -> UnitCost:
            return UnitCost(u.name, u.params,
                            u.activations * batch // max(1, self.batch),
                            u.output * batch // max(1, self.batch),
                            flops=u.flops)

        return ModelMemory([scale(u) for u in self.units],
                           scale(self.embed), scale(self.head), batch=batch)


# --------------------------------------------------------------------------
# transformer families
# --------------------------------------------------------------------------
def _lm_unit_act(cfg: ModelConfig, batch: int, seq: int, abytes: int,
                 kind: str) -> int:
    """Held activations for one layer's backward, flash-attention regime
    (no T^2 score tensor is ever materialized)."""
    B, T, D = batch, seq, cfg.d_model
    if kind == "rwkv":
        # r,k,v,g,w projections + wkv output + channel-mix hidden
        return abytes * B * T * (6 * D + 2 * cfg.d_ff)
    if kind == "mamba":
        din = cfg.ssm_expand * D
        proj = 2 * din + 2 * cfg.ssm_state_dim + cfg.ssm_num_heads
        return abytes * B * T * (proj + 2 * din)
    # attention part: block input + x_norm + q + k + v + attn_out
    hd = cfg.head_dim
    att = B * T * (2 * D + (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                   + cfg.num_heads * hd)
    if kind == "moe":
        K = cfg.experts_per_token
        f = cfg.moe_d_ff
        mlp = B * T * (D + K * 3 * f)  # routed hidden activations
        if cfg.num_shared_experts:
            mlp += B * T * 3 * f * cfg.num_shared_experts
    else:
        d_ff = cfg.dense_d_ff or cfg.d_ff
        mlp = B * T * (D + 3 * d_ff)
    return abytes * (att + mlp)


def lm_memory(cfg: ModelConfig, batch: int, seq: int, *,
              param_bytes: int = 4, act_bytes: int = 2) -> ModelMemory:
    B, T, D, V = batch, seq, cfg.d_model, cfg.vocab_size
    kinds = cfg.layer_kinds()
    out_bytes = act_bytes * B * T * D

    def unit_flops(p_bytes: int, seq: int, n_attn: int = 1,
                   kv_seq: int = None) -> int:
        # dense-equivalent forward: 2 FLOPs per weight per processed
        # token, plus one score/value quadratic per ATTENTION layer in
        # the unit (flash changes memory, not FLOPs; recurrent kinds —
        # rwkv/mamba — have no quadratic)
        return (2 * (p_bytes // param_bytes) * seq
                + n_attn * 4 * seq * (kv_seq or seq) * D)

    units = []
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        n_groups = cfg.num_layers // every
        # shared attn params counted once, priced into the head (trained
        # with φ per DESIGN.md §4)
        mamba_p = cfg._layer_params("mamba") * param_bytes
        act = _lm_unit_act(cfg, B, T, act_bytes, "mamba") * (every - 1) \
            + _lm_unit_act(cfg, B, T, act_bytes, "attn")
        # each group runs (every-1) mamba layers (no quadratic) plus the
        # shared attention layer's compute (its params are priced into
        # the head, its FLOPs happen here)
        group_fl = unit_flops(mamba_p * (every - 1), T, n_attn=0) \
            + unit_flops(cfg._attn_params() * param_bytes, T, n_attn=1)
        for g in range(n_groups):
            units.append(UnitCost(f"group_{g}", mamba_p * (every - 1),
                                  act, out_bytes, flops=group_fl))
        head_p = (cfg._attn_params() + 3 * D * cfg.d_ff + D * V
                  + 3 * D) * param_bytes
    elif cfg.is_encoder_decoder:
        S = cfg.max_source_positions
        for i in range(cfg.encoder_layers):
            p = (cfg._attn_params() + 2 * D * cfg.d_ff + 4 * D) * param_bytes
            act = act_bytes * B * S * (2 * D + 2 * cfg.d_ff)
            units.append(UnitCost(f"enc_{i}", p, act,
                                  act_bytes * B * S * D,
                                  flops=unit_flops(p, S)))
        for i in range(cfg.num_layers):
            p = (2 * cfg._attn_params() + 2 * D * cfg.d_ff + 6 * D) * param_bytes
            act = _lm_unit_act(cfg, B, T, act_bytes, "dense") \
                + act_bytes * B * T * D  # cross-attn
            # self-attention T x T plus cross-attention T x S quadratics
            fl = unit_flops(p, T, n_attn=1) \
                + unit_flops(0, T, n_attn=1, kv_seq=S)
            units.append(UnitCost(f"dec_{i}", p, act, out_bytes, flops=fl))
        head_p = D * V * param_bytes if not cfg.tie_embeddings else D * param_bytes
    else:
        m = cfg.moe_every
        for u in range(cfg.num_layers // m):
            ks = [kinds[u * m + i] for i in range(m)]
            p = sum(cfg._layer_params(k) for k in ks)
            act = sum(_lm_unit_act(cfg, B, T, act_bytes, k) for k in ks)
            n_attn = sum(k not in ("rwkv", "mamba") for k in ks)
            units.append(UnitCost(f"unit_{u}", p * param_bytes, act,
                                  out_bytes,
                                  flops=unit_flops(p * param_bytes, T,
                                                   n_attn=n_attn)))
        head_p = (D + (0 if cfg.tie_embeddings else D * V)) * param_bytes

    embed_p = V * D * param_bytes
    embed = UnitCost("embed", embed_p, out_bytes, out_bytes,
                     flops=2 * T * D)    # lookup + scale, matmul-free
    # head activations: chunked-CE regime — logits never materialized;
    # live set is one (chunk, V) tile (counted as 1/16 of full logits)
    head_act = act_bytes * B * T * D + 4 * B * T * V // 16
    head = UnitCost("head", head_p, head_act, 4 * B * T,
                    flops=2 * T * D * V)
    return ModelMemory(units, embed, head, batch=batch)

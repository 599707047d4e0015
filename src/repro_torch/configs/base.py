"""Model config dataclass shared by every architecture family.

The port's own copy of ``repro.configs.base.ModelConfig`` (pure Python, no
field changed): one frozen dataclass covers all the reference's families,
so the memory model prices any of them the same way; the port's models
build the families it has ported (``models/api.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | resnet | vit
    source: str = ""  # citation for the config numbers

    # transformer backbone
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0

    # sliding-window attention (h2o-danube); 0 -> full attention
    sliding_window: int = 0

    # M-RoPE (qwen2-vl): number of rotary sections (temporal/height/width)
    mrope_sections: Optional[Tuple[int, ...]] = None

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden; 0 -> d_ff
    moe_every: int = 1  # MoE every Nth layer (llama4 interleaves dense FFN)
    dense_d_ff: int = 0  # d_ff of interleaved dense layers; 0 -> d_ff
    num_shared_experts: int = 0
    router_aux_coef: float = 0.01

    # SSM / RWKV
    ssm_state_dim: int = 0      # mamba2 state size N
    ssm_num_heads: int = 0      # mamba2 heads (d_inner // head_dim)
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # which SSM stack a family="ssm" config uses: "rwkv6" (Finch
    # recurrence) or "mamba2" (SSD scan, the zamba2 layer as a pure stack)
    ssm_kind: str = "rwkv6"

    # hybrid (zamba2): indices of layers that are attention (shared block)
    hybrid_attn_every: int = 0  # an attention block every N mamba blocks
    shared_attention: bool = False  # zamba2 shares one attn block's params

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_source_positions: int = 0   # audio frames after conv frontend

    # vlm / audio frontend stub
    frontend_embed_tokens: int = 0  # number of frontend tokens prepended

    # training defaults
    max_seq_len: int = 8192

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_d_ff == 0 and self.num_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived quantities --------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind tags, in depth order (used by the decomposer)."""
        if self.family == "ssm":
            kind = "mamba" if self.ssm_kind == "mamba2" else "rwkv"
            return tuple(kind for _ in range(self.num_layers))
        if self.family == "hybrid":
            kinds = []
            for i in range(self.num_layers):
                if self.hybrid_attn_every and (i % self.hybrid_attn_every
                                               == self.hybrid_attn_every - 1):
                    kinds.append("attn_shared" if self.shared_attention else "attn")
                else:
                    kinds.append("mamba")
            return tuple(kinds)
        if self.family == "moe":
            return tuple(
                "moe" if (i % self.moe_every == self.moe_every - 1) else "dense"
                for i in range(self.num_layers))
        return tuple("dense" for _ in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d  # lm head
        n += self._encoder_params()
        kinds = self.layer_kinds()
        seen_shared = False
        for k in kinds:
            if k == "attn_shared":
                if not seen_shared:
                    n += self._attn_params() + 2 * d
                    seen_shared = True
                continue
            n += self._layer_params(k)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        expert_p = 3 * self.d_model * self.moe_d_ff
        inactive = (self.num_experts - self.experts_per_token)
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == "moe")
        return total - n_moe_layers * inactive * expert_p

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            p += (nq + 2 * nkv) * hd
        return p

    def _mlp_params(self) -> int:
        d_ff = self.dense_d_ff or self.d_ff
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "dense":
            return self._attn_params() + self._mlp_params() + 2 * d
        if kind == "moe":
            expert_p = 3 * d * self.moe_d_ff * self.num_experts
            shared_p = 3 * d * self.moe_d_ff * self.num_shared_experts
            router_p = d * self.num_experts
            return self._attn_params() + expert_p + shared_p + router_p + 2 * d
        if kind == "rwkv":
            # time-mix: r,k,v,g,o projections + data-dependent mix/decay
            # LoRA (rank 32); channel-mix: k,v ffn + r gate
            lora = 12 * 32 * d
            tm = 5 * d * d + lora + 2 * d
            cm = 2 * d * self.d_ff + d * d
            return tm + cm + 2 * d
        if kind == "mamba":
            # exact for models/mamba2.py: in_proj emits [z|x|B|C|dt] with
            # B,C shared across heads (single N each, not N per head)
            d_in = self.ssm_expand * d
            N = self.ssm_state_dim
            nh = max(1, self.ssm_num_heads)
            p = d * (2 * d_in + 2 * N + nh)  # in_proj
            p += d_in * d                    # out proj
            p += 5 * d_in                    # conv kernel (K=4) + bias
            p += 3 * nh                      # dt_bias, A_log, D
            return p + d                     # pre-norm
        if kind in ("attn", "attn_shared"):
            return self._attn_params() + 2 * d
        raise ValueError(kind)

    def _encoder_params(self) -> int:
        if not self.is_encoder_decoder:
            return 0
        d = self.d_model
        per = self._attn_params() + 2 * d * self.d_ff + 2 * d
        # decoder cross-attention adds one more attention block per decoder
        # layer; learned position tables for both stacks
        cross = self.num_layers * (self._attn_params() + d)
        pos = (self.max_seq_len + self.max_source_positions) * d
        return self.encoder_layers * per + cross + pos


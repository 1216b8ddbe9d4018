"""Model and run configuration schema, copied from ``repro.configs.base``.

A model is a sequence of *layer groups*; each group is a repeated
*superblock* (a short tuple of layer kinds) applied ``count`` times with
parameters stacked over the count, as in the JAX package, so that its
parameter trees load 1:1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# Layer descriptor kinds (the port runs all six; ATTN and LOCAL layers take
# the MoE layer in place of their MLP where the config has experts).
ATTN = "attn"        # global self-attention (causal for decoders)
LOCAL = "local"      # sliding-window self-attention
XATTN = "xattn"      # cross-attention layer w/ own MLP (llama-vision style)
ATTNX = "attn_x"     # self-attn + cross-attn + MLP in one layer (whisper dec)
RWKV = "rwkv"        # RWKV6 time-mix + channel-mix
RGLRU = "rglru"      # RG-LRU recurrent block (griffin)


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    pattern: Tuple[str, ...]  # superblock layer kinds, applied in order
    count: int  # number of stacked repetitions

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.count


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: Tuple[LayerGroup, ...]
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention details
    window: int = 0  # sliding window for LOCAL layers
    attn_softcap: float = 0.0  # gemma2 attention logit soft-capping
    logit_softcap: float = 0.0  # gemma2 final logit soft-capping
    rope_theta: float = 10_000.0
    pos: str = "rope"  # rope | learned | none
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"  # silu | gelu
    gated: bool = True  # GLU-style MLP (SwiGLU/GeGLU); False = plain 2-matmul MLP
    post_norms: bool = False  # gemma2-style post-attn/post-ffn norms
    tie_embeddings: bool = False
    # encoder / frontend stubs
    encoder_layers: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0
    # recurrent blocks
    rwkv_head_dim: int = 64
    wkv_chunk: int = 32
    lru_width: int = 0
    conv_width: int = 4
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256, as in the JAX package."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does *unwindowed* self-attention over the full
        sequence with an unbounded KV cache: the dry-run's ``long_500k``
        gate.  gemma2 counts: its global layers are O(S) per decoded token
        and the arch is not pure full attention."""
        kinds = {k for g in self.groups for k in g.pattern}
        if kinds <= {LOCAL, RWKV, RGLRU, XATTN}:
            return True
        # mixed local/global (gemma2) or recurrent/local counts as sub-quadratic
        return (ATTN in kinds or ATTNX in kinds) and (
            LOCAL in kinds or RGLRU in kinds or RWKV in kinds
        )

    def param_count(self) -> int:
        """Analytic parameter count, the JAX package's (its roofline's
        model FLOPs and the dry-run's ``params``)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_padded
        dh = self.head_dim_
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        lru = self.lru_width or d

        def attn_params() -> int:
            return d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d

        def xattn_params() -> int:
            fd = self.frontend_dim or d
            return d * self.n_heads * dh + 2 * fd * self.n_kv_heads * dh + self.n_heads * dh * d

        def mlp_params() -> int:
            mult = 3 if self.gated else 2
            return mult * d * ff

        def moe_params() -> int:
            return d * self.n_experts + self.n_experts * 3 * d * ff

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,o projections + decay lora + token-shift mixes
            tm = 5 * d * d + 2 * d * 64 + 6 * d
            # channel-mix: k (d->ff), v (ff->d), r (d->d)
            cm = d * ff + ff * d + d * d
            return tm + cm

        def rglru_params() -> int:
            # conv + in-proj (d -> 2*lru) + gates + out-proj
            return self.conv_width * lru + d * 2 * lru + 2 * lru * lru // 8 + 2 * lru + lru * d

        per_kind = {
            ATTN: lambda: attn_params() + (moe_params() if self.is_moe else mlp_params()),
            LOCAL: lambda: attn_params() + (moe_params() if self.is_moe else mlp_params()),
            XATTN: lambda: xattn_params() + mlp_params(),
            ATTNX: lambda: attn_params() + xattn_params() + mlp_params(),
            RWKV: lambda: rwkv_params(),
            RGLRU: lambda: rglru_params() + mlp_params(),
        }
        for g in self.groups:
            for kind in g.pattern:
                n += g.count * per_kind[kind]()
        if self.encoder_layers:
            n += self.encoder_layers * (attn_params() + mlp_params())
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_experts = self.n_experts * 3 * d * ff
        active_experts = self.top_k * 3 * d * ff
        n_moe_layers = sum(
            g.count for g in self.groups for k in g.pattern if k in (ATTN, LOCAL)
        )
        return self.param_count() - n_moe_layers * (dense_experts - active_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell's shape: (kind, seq_len, global_batch)."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training run knobs: the fields of the JAX package's ``RunConfig``
    that ``train_step`` reads and its distribution fields, with its
    defaults; the seed and the checkpoint settings are
    ``launch.train.run``'s arguments.  As in the reference, nothing reads
    the distribution fields (FSDP acts through
    ``sharding.param_shardings(fsdp=)``)."""

    model: ModelConfig
    seq_len: int = 4096
    global_batch: int = 256
    n_microbatches: int = 8
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # distribution
    fsdp: bool = True
    remat: bool = True
    remat_policy: str = "block"  # block | dots | none
    grad_accum_dtype: str = "float32"  # float32 | bfloat16
    grad_allreduce: str = "auto"  # auto | flat | hierarchical (multi-pod)
    moe_alltoall: str = "auto"  # auto | direct | hierarchical
    grad_compression: str = "none"  # none | int8

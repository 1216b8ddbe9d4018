"""Model and run configuration schema, copied from ``repro.configs.base``.

A model is a sequence of *layer groups*; each group is a repeated
*superblock* (a short tuple of layer kinds) applied ``count`` times with
parameters stacked over the count, as in the JAX package, so that its
parameter trees load 1:1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

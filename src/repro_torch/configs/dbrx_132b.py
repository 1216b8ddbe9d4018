"""dbrx-132b — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ATTN, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    groups=(LayerGroup(pattern=(ATTN,), count=40),),
    head_dim=128,
    n_experts=16,
    top_k=4,
    norm="layernorm",
    act="silu",
    rope_theta=500_000.0,
)

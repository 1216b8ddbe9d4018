"""olmo-1b — 16L d_model=2048 16H (kv=16, MHA) d_ff=8192 vocab=50304,
non-parametric LayerNorm.  [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ATTN, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    groups=(LayerGroup(pattern=(ATTN,), count=16),),
    head_dim=128,
    norm="nonparam_ln",
    act="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)

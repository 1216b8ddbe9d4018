"""llama3.2-1b — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ATTN, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    groups=(LayerGroup(pattern=(ATTN,), count=16),),
    head_dim=64,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    rope_theta=500_000.0,
)

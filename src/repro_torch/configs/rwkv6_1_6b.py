"""rwkv6-1.6b (Finch) — 24L d_model=2048 attention-free, data-dependent
decay, d_ff=7168 vocab=65536.  [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import LayerGroup, ModelConfig, RWKV

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    groups=(LayerGroup(pattern=(RWKV,), count=24),),
    rwkv_head_dim=64,
    norm="layernorm",
    act="silu",
    pos="none",
)

"""gemma2-9b — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local+global alternating attention, logit softcapping.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ATTN, LOCAL, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256_000,
    groups=(LayerGroup(pattern=(LOCAL, ATTN), count=21),),  # 42 layers
    head_dim=256,
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    norm="rmsnorm",
    act="gelu",
    post_norms=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

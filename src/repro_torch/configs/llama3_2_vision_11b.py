"""llama-3.2-vision-11b — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer (vision tower is a
STUB: input_specs supplies precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ATTN, XATTN, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    # 40 layers: 8 superblocks of 4 self-attn + 1 cross-attn
    groups=(LayerGroup(pattern=(ATTN, ATTN, ATTN, ATTN, XATTN), count=8),),
    head_dim=128,
    frontend_tokens=1601,  # 1 tile x (40x40+1) CLIP-style patches
    frontend_dim=7680,  # vision-encoder output width
    norm="rmsnorm",
    act="silu",
    rope_theta=500_000.0,
)

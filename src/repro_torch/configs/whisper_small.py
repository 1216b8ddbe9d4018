"""whisper-small — enc-dec, 12L (each side) d_model=768 12H d_ff=3072
vocab=51865, conv audio frontend (STUB: input_specs supplies precomputed
frame embeddings (B, 1500, d)).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ATTNX, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    # decoder: every layer = causal self-attn + cross-attn over audio frames
    groups=(LayerGroup(pattern=(ATTNX,), count=12),),
    head_dim=64,
    encoder_layers=12,
    frontend_tokens=1500,
    norm="layernorm",
    act="gelu",
    gated=False,  # plain 2-matmul MLP
    pos="learned",
    tie_embeddings=True,
)

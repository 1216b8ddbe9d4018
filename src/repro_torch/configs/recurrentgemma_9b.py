"""recurrentgemma-9b — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention at 2:1.  [arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import LOCAL, LayerGroup, ModelConfig, RGLRU

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    # 38 = 12 x (rglru, rglru, local) + 1 x (rglru, rglru)
    groups=(
        LayerGroup(pattern=(RGLRU, RGLRU, LOCAL), count=12),
        LayerGroup(pattern=(RGLRU, RGLRU), count=1),
    ),
    head_dim=256,
    window=2048,
    lru_width=4096,
    conv_width=4,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)

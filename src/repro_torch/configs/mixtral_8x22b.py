"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import LOCAL, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    groups=(LayerGroup(pattern=(LOCAL,), count=56),),
    head_dim=128,
    n_experts=8,
    top_k=2,
    window=4096,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)

"""codeqwen1.5-7b — 32L d_model=4096 32H (GQA kv=32, i.e. MHA) d_ff=13440
vocab=92416.  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ATTN, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92_416,
    groups=(LayerGroup(pattern=(ATTN,), count=32),),
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)

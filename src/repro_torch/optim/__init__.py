from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "clip_by_global_norm", "global_norm",
           "init_state", "warmup_cosine"]

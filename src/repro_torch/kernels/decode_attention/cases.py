"""The decode shapes that the kernel is held against its plain version at,
and the inputs drawn there: one list for the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` (phase 3 checks every
case in bf16 and f32, phase 7 times ``MAIN_PATHS``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# (label, B, H, G, cap, dh, pos, window, softcap).  The benchmark's two
# decode shapes mid-batch (olmo-1b.chat at step 128, mixtral-8x22b-d8's long
# prompts at step 8); each serving path's decode shape as ``chip_smoke.py``
# serves it (B=4, a prompt of 512 and 32 new: 544 slots) with pos late in the
# cache, which covers every template the serving paths launch (M = 1, 2..4,
# 5..8 and 16 heads a KV head, dh 64, 128 and 256, split and whole caches);
# LOCAL rings that have wrapped (window == cap); one sequence whose 4096
# slots split where most splits hold nothing; the smoke configs' dh 32
CASES = [
    ("olmo_chat", 64, 16, 16, 1280, 128, 1151, 0, 0.0),
    ("mixtral_long_prompt", 8, 48, 8, 2064, 128, 2055, 0, 0.0),
    ("olmo_serve", 4, 16, 16, 544, 128, 540, 0, 0.0),
    ("codeqwen_serve", 4, 32, 32, 544, 128, 540, 0, 0.0),
    ("llama_vision_serve", 4, 32, 8, 544, 128, 540, 0, 0.0),
    ("mixtral_dbrx_serve", 4, 48, 8, 544, 128, 540, 0, 0.0),
    ("llama_gqa_dh64", 4, 32, 8, 544, 64, 540, 0, 0.0),
    ("gemma2_global_softcap", 4, 16, 8, 544, 256, 540, 0, 50.0),
    ("gemma2_local_serve_softcap", 4, 16, 8, 544, 256, 540, 4096, 50.0),
    ("recurrentgemma_local_serve", 4, 16, 1, 544, 256, 540, 2048, 0.0),
    ("gemma2_local_ring_softcap", 4, 16, 8, 4096, 256, 5000, 4096, 50.0),
    ("recurrentgemma_local_ring", 4, 16, 1, 2048, 256, 2600, 2048, 0.0),
    ("whisper_decoder", 4, 12, 12, 448, 64, 100, 0, 0.0),
    ("empty_splits", 1, 8, 1, 4096, 128, 100, 0, 0.0),
    ("smoke_dh32", 2, 4, 2, 46, 32, 41, 0, 0.0),
]
MAIN_PATHS = ("olmo_chat", "mixtral_long_prompt")


def decode_inputs(device, B, H, G, cap, dh, pos, window, dtype, seed: int = 0) -> Tuple:
    """q (B, H, dh) and k, v (B, cap, G, dh) standard normal in ``dtype``,
    drawn on ``device``; k_pos (cap,) and pos: the cache as decode reads it
    at ``pos``, padded (slots 0 .. pos, -1 above) or, where window == cap, a
    ring of the last cap positions."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    held = np.arange(max(0, pos - cap + 1), pos + 1) if window == cap else np.arange(pos + 1)
    k_pos = torch.full((cap,), -1, dtype=torch.int32)
    k_pos[torch.from_numpy(held % cap)] = torch.from_numpy(held.astype(np.int32))
    return (draw(B, H, dh), draw(B, cap, G, dh), draw(B, cap, G, dh), k_pos.to(device),
            torch.tensor(pos, dtype=torch.int32, device=device))

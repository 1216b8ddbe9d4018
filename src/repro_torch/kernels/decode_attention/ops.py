"""Model-layout entry point: the decode-attention kernel on the card, the
plain version on the CPU.

There is no fallback between the two: a CUDA tensor goes to the kernel (which
raises on what it does not take), a CPU tensor to ``decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention as _kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# calls served by the plain version (CPU tensors)
plain_calls = 0


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k_cache: torch.Tensor,  # (B, cap, G, dh)
    v_cache: torch.Tensor,
    k_pos: torch.Tensor,  # (cap,) int32
    pos: torch.Tensor,  # 0-d int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    """(B, H, dh) in v's dtype: ``q``'s attention over the slots attendable
    from ``pos``."""
    global plain_calls
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        plain_calls += 1
        return decode_attention_ref(q, k_cache, v_cache, k_pos, pos, **kw)
    return _kernel(q, k_cache, v_cache, k_pos, pos, **kw)

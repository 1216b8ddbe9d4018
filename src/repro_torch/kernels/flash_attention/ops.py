"""Model-layout entry point: the kernel on the card, the plain version on the CPU.

There is no fallback between the two: a CUDA tensor goes to the kernel (which
raises on what it does not take), a CPU tensor to ``attention_ref``.  The
kernel masks ragged edges itself, so unlike the JAX package no sequence length
is routed to the plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

# calls served by the plain version (CPU tensors)
plain_calls = 0


def attention(
    q: torch.Tensor,  # (B, Sq, H, dh) — model layout
    k: torch.Tensor,  # (B, Sk, G, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    global plain_calls
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    if q.device.type == "cpu":
        plain_calls += 1
        out = attention_ref(qt, kt, vt, **kw)
    else:
        out = flash_attention(qt, kt, vt, **kw)
    return out.transpose(1, 2)

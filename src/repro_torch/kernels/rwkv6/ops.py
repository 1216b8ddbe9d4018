"""Model-layout entry point: the WKV6 kernel on the card, the plain version on the CPU.

There is no fallback between the two: a CUDA tensor goes to the kernel (which
raises on what it does not take), a CPU tensor to ``wkv6_ref``.  The kernel
handles a partial last chunk itself, so unlike the JAX package no sequence
length is routed to the plain version on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rwkv6.kernel import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref

# calls served by the plain version (CPU tensors)
plain_calls = 0


def wkv(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,
    u: torch.Tensor,  # (H, K)
    *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns y (B, S, H, K) in r's dtype and the final state (B, H, K, K) f32."""
    global plain_calls
    if r.device.type == "cpu":
        plain_calls += 1
        return wkv6_ref(r, k, v, log_w, u)
    return wkv6(r, k, v, log_w, u, chunk=chunk)

"""Plain PyTorch version of the RG-LRU scan kernel: the sequential recurrence.

    h_t = a_t * h_{t-1} + b_t        (per channel, h_{-1} = h0 or 0)

a, b: (B, S, W).  Ported from ``repro.kernels.rglru.ref.rglru_ref``: computes
in f32, returns every h_t in a's dtype and the final h in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rglru_ref(
    a: torch.Tensor,  # (B, S, W) decay in (0, 1]
    b: torch.Tensor,  # (B, S, W) gated input
    h0: Optional[torch.Tensor] = None,  # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, W = a.shape
    h = (h0.float() if h0 is not None
         else torch.zeros((B, W), dtype=torch.float32, device=a.device))
    af, bf = a.float(), b.float()
    hs = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype), h

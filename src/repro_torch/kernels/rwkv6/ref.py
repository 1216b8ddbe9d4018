"""Plain PyTorch version of the WKV6 kernel: the token-by-token recurrence.

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(log_w_t)

r, k, v, log_w: (B, S, H, K);  u: (H, K);  state: (B, H, K, V) with V = K.
Ported from ``repro.kernels.rwkv6.ref.wkv6_ref``: computes in f32, returns y
in r's dtype and the final state in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,
    u: torch.Tensor,
    state0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, K = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(log_w.float())
    uf = u.float()[None, :, :, None]  # (1, H, K, 1)
    state = (state0.float().clone() if state0 is not None
             else torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device))
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = w[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), state

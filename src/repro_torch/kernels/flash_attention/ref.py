"""Plain PyTorch version of the flash-attention kernel.

Same contract as ``repro.kernels.flash_attention.ref.attention_ref``:
  q: (B, H, Sq, dh)    k, v: (B, G, Sk, dh)    GQA: H = G * rep.
Returns (B, H, Sq, dh) in q's dtype.  Softmax in f32; causal and
sliding-window masks on absolute positions (q_offset shifts the queries).
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, H, Sq, dh = q.shape
    G, Sk = k.shape[1], k.shape[2]
    rep = H // G
    qg = q.reshape(B, G, rep, Sq, dh).float()
    logits = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * (dh**-0.5)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    logits = logits.masked_fill(~ok, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,bgtd->bgrsd", probs, v.float())
    return out.reshape(B, H, Sq, dh).to(q.dtype)

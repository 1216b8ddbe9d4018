"""Plain PyTorch version of the decode-attention kernel, and the port's
decode attention over a whole cache sequence (``models/attention.py``
``decode_attention`` calls it with kernels off): the math of the dense
attention path (``_split_groups``, ``_mask_bias`` and ``_attend_dense``) on a
single query position, op for op, so it equals that path bit for bit.

  q: (B, H, dh)    k_cache, v_cache: (B, cap, G, dh)    GQA: H = G * M.
  k_pos: (cap,) int32, each slot's position (-1 unwritten); pos: 0-d int32.

Returns (B, H, dh) in v's dtype.  Logits and softmax in f32 against the
cache cast to f32; the probabilities rounded to v's dtype before P.V.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import NEG_INF, softcap as _softcap


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_pos: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    B, H, dh = q.shape
    G = k_cache.shape[2]
    qg = q.reshape(B, 1, G, H // G, dh)
    q_pos = pos.view(1)
    ok = torch.ones((1, k_pos.shape[0]), dtype=torch.bool, device=q.device)
    ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    ok &= k_pos[None, :] >= 0  # unwritten slots carry -1
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=q.device).masked_fill_(~ok, NEG_INF)
    logits = torch.einsum("bsgmd,btgd->bgmst", qg.float(), k_cache.float()) * scale
    logits = _softcap(logits, softcap)
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bgmst,btgd->bsgmd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, dh)

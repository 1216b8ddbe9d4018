"""Plain PyTorch version of the WKV6 kernel: the token-by-token recurrence.

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(log_w_t)

r, k, v, log_w: (B, S, H, K);  u: (H, K);  state: (B, H, K, V) with V = K.
Ported from ``repro.kernels.rwkv6.ref.wkv6_ref``: computes in f32, returns y
in r's dtype and the final state in f32.

``wkv6_split_ref`` mirrors the CUDA kernel's decomposition in plain PyTorch
(the chunk-parallel pass, then the state chain over slices of V) so that the
algebra can be checked without a card.  Only tests use it.
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


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def wkv6_split_ref(r, k, v, log_w, u, *, chunk: int = 32, vb: int = 16):
    """The kernel's two passes from a zero state.  Intra (each chunk alone):
    cumulative log-decays as compensated hi + lo pairs with a leading zero
    row (row t is cum_ex[t], row t + 1 cum[t]), att with the bonus on the
    diagonal and zeros above it, rd = r exp(cum_ex), kd = k exp(cum_L - cum),
    dec = exp(cum_L).  Then the chain, slice by slice of ``vb`` columns:
    y = att v + rd S, S = dec S + kd^T v.  Positions past S are padded with
    k = v = 0 and log_w = 0, as the kernel stages them."""
    B, S, H, K = r.shape
    L, nc = chunk, -(-S // chunk)

    def chunks(a):  # (B, S, H, K) f32 -> (B, H, nc, L, K), zero-padded
        a = torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, nc * L - S))
        return a.reshape(B, nc, L, H, K).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc = (chunks(a) for a in (r, k, v, log_w))
    hi = torch.zeros_like(wc[..., :1, :])
    lo = torch.zeros_like(hi)
    ch, cl = [hi], [lo]
    for t in range(L):
        hi, e = _two_sum(hi, wc[..., t:t + 1, :])
        lo = lo + e
        ch.append(hi)
        cl.append(lo)
    ch, cl = torch.cat(ch, -2), torch.cat(cl, -2)  # (B, H, nc, L + 1, K)
    d = (ch[..., :L, None, :] - ch[..., None, 1:, :]) + (cl[..., :L, None, :] - cl[..., None, 1:, :])
    pair = rc[..., :, None, :] * kc[..., None, :, :]  # [t, s, k]
    att = (pair * torch.exp(torch.clamp(d, max=0.0))).sum(-1)
    bonus = (rc * u.float()[None, :, None, None, :] * kc).sum(-1)
    att = torch.tril(att, -1) + torch.diag_embed(bonus)
    rd = rc * torch.exp(ch[..., :L, :] + cl[..., :L, :])
    kd = kc * torch.exp((ch[..., L:, :] - ch[..., 1:, :]) + (cl[..., L:, :] - cl[..., 1:, :]))
    dec = torch.exp(ch[..., L, :] + cl[..., L, :])  # (B, H, nc, K)

    y = torch.empty_like(vc)
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    for j in range(0, K, vb):
        sl = slice(j, j + vb)
        st = state[..., sl]
        for c in range(nc):
            y[:, :, c, :, sl] = att[:, :, c] @ vc[:, :, c, :, sl] + rd[:, :, c] @ st
            st = dec[:, :, c, :, None] * st + kd[:, :, c].transpose(-1, -2) @ vc[:, :, c, :, sl]
        state[..., sl] = st
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, K)[:, :S]
    return y.to(r.dtype), state

"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix.

Ported from ``repro.models.rwkv``.  The WKV6 recurrence per head (key dim K,
value dim V, both = rwkv_head_dim):

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t in (0,1), data-dependent

Three implementations, all agreeing (tested against the JAX package):
  * ``wkv_recurrent`` — the step-by-step loop (the oracle, the kernel's plain
    version ``wkv6_ref``); ``wkv_decode_step`` is one step of it.
  * ``wkv_chunked``   — chunk-parallel form: intra-chunk pairwise decays via
    an (L, L, K) product, cross-chunk via a carried state.
  * the CUDA kernel (``repro_torch.kernels.rwkv6``) for prefill on the card.

Stability: all decay algebra runs on log-decays; every exp() argument is a
*difference* of cumulative log-decays bounded above by 0, so nothing
overflows regardless of chunk length.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.config import kernels_enabled
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models.common import dense_init, dtype_of

WKV_CHUNK = 32
DECAY_LORA = 64


# --------------------------------------------------------------------------
# Parameters: the JAX package's keys, shapes and dtypes (mixes, decay, bonus
# and group-norm scale in f32; the matrices in the model dtype).
# --------------------------------------------------------------------------

def rwkv_params(cfg: ModelConfig, gen: torch.Generator, lead: Tuple[int, ...] = ()) -> dict:
    """``lead`` prepends stacking axes (a layer group's count)."""
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    H = d // cfg.rwkv_head_dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        # time-mix
        "mu": torch.full(lead + (5, d), 0.5, **f32),  # w, r, k, v, g mixing
        "w0": torch.full(lead + (d,), -1.0, **f32),  # decay base
        "decay_A": dense_init(gen, lead + (d, DECAY_LORA), torch.float32, fan_in=d),
        "decay_B": dense_init(gen, lead + (DECAY_LORA, d), torch.float32, fan_in=DECAY_LORA),
        "u": torch.full(lead + (d,), 0.1, **f32),  # per-channel bonus
        "wr": dense_init(gen, lead + (d, d), dt, fan_in=d),
        "wk": dense_init(gen, lead + (d, d), dt, fan_in=d),
        "wv": dense_init(gen, lead + (d, d), dt, fan_in=d),
        "wg": dense_init(gen, lead + (d, d), dt, fan_in=d),
        "wo": dense_init(gen, lead + (d, d), dt, fan_in=d),
        "ln_scale": torch.ones(lead + (H, cfg.rwkv_head_dim), **f32),  # group norm
        # channel-mix
        "cmu": torch.full(lead + (2, d), 0.5, **f32),  # k, r mixing
        "cm_k": dense_init(gen, lead + (d, ff), dt, fan_in=d),
        "cm_v": dense_init(gen, lead + (ff, d), dt, fan_in=ff),
        "cm_r": dense_init(gen, lead + (d, d), dt, fan_in=d),
    }


# --------------------------------------------------------------------------
# WKV6 core.  r, k, v: (B, S, H, K); log_w: (B, S, H, K) (log decay, < 0);
# u: (H, K).  Returns y: (B, S, H, K) and final state (B, H, K, V).
# --------------------------------------------------------------------------

# The step-by-step recurrence (the oracle) is the kernel's plain version.
wkv_recurrent = wkv6_ref


def wkv_decode_step(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: r, k, v, log_w (B, H, K); state (B, H, K, V).  Returns y in
    r's dtype and a new state."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(log_w.float())
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, state + u[None, :, :, None] * kv)
    return y.to(r.dtype), w[..., None] * state + kv


def wkv_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    state0: Optional[torch.Tensor] = None, chunk: int = WKV_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, K = r.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # padded positions must not pollute the carried state: zero k/v, and
        # decay 1 (log 0) so the state passes through
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, log_w))
    n = r.shape[1] // L

    def to_chunks(a):  # (B, n*L, H, K) -> (n, B, L, H, K) f32
        return a.reshape(B, n, L, H, K).transpose(0, 1).float()

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, log_w))
    state = (state0 if state0 is not None
             else torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    ys = []
    for rr, kk, vv, lw in zip(rc, kc, vc, lwc):  # each (B, L, H, K)
        cum = torch.cumsum(lw, dim=1)  # inclusive cumulative log decay
        cum_ex = cum - lw  # exclusive: sum of log w over 1..t-1
        # intra-chunk: prod_{j=s+1}^{t-1} w_j = exp(cum_ex[t] - cum[s]), s < t
        D = cum_ex[:, :, None] - cum[:, None]  # (B, L, L, H, K)
        P = rr[:, :, None] * kk[:, None] * torch.exp(torch.clamp(D, max=0.0))
        att = P.sum(-1) * tri[None, :, :, None]  # (B, L, L, H)
        y_intra = torch.einsum("btsh,bshv->bthv", att, vv)
        # diagonal (current token) with bonus u
        y_diag = (rr * u[None, None] * kk).sum(-1, keepdim=True) * vv
        # cross-chunk: decay from chunk entry to t is exp(cum_ex[t])
        y_cross = torch.einsum("bthk,bhkv->bthv", rr * torch.exp(cum_ex), state)
        # S' = exp(cum_L) * S + sum_s exp(cum_L - cum_s) k_s v_s
        A_L = torch.exp(cum[:, -1])  # (B, H, K)
        decay_to_end = torch.exp(cum[:, -1][:, None] - cum)  # (B, L, H, K) <= 1
        state = A_L[..., None] * state + torch.einsum(
            "bthk,bthv->bhkv", kk * decay_to_end, vv)
        ys.append(y_intra + y_diag + y_cross)
    y = torch.stack(ys, dim=1).reshape(B, n * L, H, K)[:, :S]
    return y.to(r.dtype), state


# --------------------------------------------------------------------------
# Block application.
# --------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: x_prev[t] = x[t-1]; position 0 gets ``prev`` (or 0)."""
    first = prev[:, None] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm of (B, S, H, K): population variance, no bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale[None, None]).to(x.dtype)


def _time_mix_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor, shifted: torch.Tensor):
    xf, sf = x.float(), shifted.float()
    mixed = xf[None] + (sf - xf)[None] * p["mu"][:, None, None, :]  # (5, B, S, d)
    mw, mr, mk, mv, mg = mixed
    log_w = -torch.exp(
        torch.clamp(p["w0"] + torch.tanh(mw @ p["decay_A"]) @ p["decay_B"], -8.0, 8.0)
    )  # (B, S, d) f32, < 0
    dt = x.dtype
    r = mr.to(dt) @ p["wr"]
    k = mk.to(dt) @ p["wk"]
    v = mv.to(dt) @ p["wv"]
    g = F.silu(mg.to(dt) @ p["wg"])
    return r, k, v, g, log_w


def _heads(cfg: ModelConfig, a: torch.Tensor) -> torch.Tensor:
    B, S, d = a.shape
    K = cfg.rwkv_head_dim
    return a.reshape(B, S, d // K, K)


def _wkv_dispatch(rh, kh, vh, lwh, u, chunked: bool, chunk: int = WKV_CHUNK):
    """The kernel's entry point when kernels are on (``use_kernels``): the
    CUDA kernel on the card for every S, its plain version on the CPU.
    Otherwise the chunked scan, or the recurrence when ``chunked`` is False."""
    if kernels_enabled():
        return wkv_ops.wkv(rh, kh, vh, lwh, u, chunk=chunk)
    if chunked:
        return wkv_chunked(rh, kh, vh, lwh, u, chunk=chunk)
    return wkv_recurrent(rh, kh, vh, lwh, u)


def rwkv_time_mix_prefill(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, chunked: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-mix over the whole sequence; also returns the final WKV state
    (B, H, K, V) f32."""
    shifted = _shift(x)
    r, k, v, g, log_w = _time_mix_inputs(cfg, p, x, shifted)
    H = cfg.d_model // cfg.rwkv_head_dim
    u = p["u"].reshape(H, cfg.rwkv_head_dim)
    rh, kh, vh, lwh = (_heads(cfg, a) for a in (r, k, v, log_w))
    y, state = _wkv_dispatch(rh, kh, vh, lwh, u, chunked, cfg.wkv_chunk)
    y = _group_norm(y, p["ln_scale"])
    y = y.reshape(x.shape) * g
    return y @ p["wo"], state


def rwkv_time_mix(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, chunked: bool = True
) -> torch.Tensor:
    return rwkv_time_mix_prefill(cfg, p, x, chunked=chunked)[0]


def _channel_mix(p: dict, x: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    xf, sf = x.float(), shifted.float()
    mk = (xf + (sf - xf) * p["cmu"][0]).to(x.dtype)
    mr = (xf + (sf - xf) * p["cmu"][1]).to(x.dtype)
    kk = torch.square(F.relu(mk @ p["cm_k"]))
    return torch.sigmoid(mr @ p["cm_r"]) * (kk @ p["cm_v"])


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(p, x, _shift(x))


# --------------------------------------------------------------------------
# Decode (single token) with carried state.
# cache = {"state": (B,H,K,V) f32, "tm_shift": (B,d), "cm_shift": (B,d)}
# The decode functions write the new state and shifts into the cache's
# tensors in place and hand back the same dict; the JAX package returns a
# new one.
# --------------------------------------------------------------------------

def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    K = cfg.rwkv_head_dim
    H = d // K
    return {
        "state": torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
        "tm_shift": torch.zeros((batch, d), dtype=dtype_of(cfg), device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype_of(cfg), device=device),
    }


def rwkv_time_mix_decode(
    cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict
) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d); updates cache['state'] and cache['tm_shift'] in place."""
    B = x.shape[0]
    shifted = cache["tm_shift"][:, None]
    r, k, v, g, log_w = _time_mix_inputs(cfg, p, x, shifted)
    H = cfg.d_model // cfg.rwkv_head_dim
    u = p["u"].reshape(H, cfg.rwkv_head_dim)
    y, new_state = wkv_decode_step(*(_heads(cfg, a)[:, 0] for a in (r, k, v, log_w)),
                                   u, cache["state"])
    y = _group_norm(y.reshape(B, 1, H, cfg.rwkv_head_dim), p["ln_scale"])
    y = y.reshape(B, 1, cfg.d_model) * g
    cache["state"].copy_(new_state)
    cache["tm_shift"].copy_(x[:, 0])
    return y @ p["wo"], cache


def rwkv_channel_mix_decode(
    cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict
) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d); updates cache['cm_shift'] in place."""
    out = _channel_mix(p, x, cache["cm_shift"][:, None])
    cache["cm_shift"].copy_(x[:, 0])
    return out, cache

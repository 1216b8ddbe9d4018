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

Over the model axis (``sharding.tp``), given the rank's blocks, the layer
computes on its heads as the reference's GSPMD splits it: the time-mix's
projections column-parallel, the decay's low-rank product over the rank's
rows of ``decay_A`` with one all-reduce, WKV and the group norm on the
rank's heads, ``wo`` row-parallel with one all-reduce; the channel-mix's
``cm_k`` column- and ``cm_v`` row-parallel, its gate on the rank's columns
of ``cm_r`` between a reduce-scatter and an all-gather.  Whole leaves
compute whole.  Given also the rank's FSDP blocks over the data axes (a
decode step's ``DistContext.data_split``, :func:`fsdp_split`), the products
that read the channels contract over the rank's block of them, their
partial sums all-reduced over the data axes together (the decay's over the
rank's rows of ``decay_A``, and the gate's over its rows of ``cm_r``
narrowed to the rank's model columns), and ``wo``/``cm_v`` write the
rank's block of the output's channels, gathered over the data axes.

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
from repro_torch.sharding import tp

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


# the leaves a split layer holds as this rank's blocks over the model axis
# (``specs.SPLIT_COMPUTE``): (dim, whole size from (d, ff, H)) each
_SPLIT_DIMS = {"wr": (-1, "d"), "wk": (-1, "d"), "wv": (-1, "d"), "wg": (-1, "d"),
               "wo": (0, "d"), "decay_B": (-1, "d"), "ln_scale": (0, "H"),
               "cm_k": (-1, "ff"), "cm_v": (0, "ff")}


def tp_split(cfg: ModelConfig, p: dict, dist=None) -> bool:
    """Whether the layer's leaves (one layer's, unstacked) are this rank's
    blocks over the model axis: its heads' channels of ``wr``/``wk``/``wv``/
    ``wg``/``decay_B`` and rows of ``wo``, its heads of ``ln_scale``, its FF
    block of ``cm_k``/``cm_v`` (all of them or none; anything else raises).
    The other leaves are whole either way."""
    whole = {"d": cfg.d_model, "ff": cfg.d_ff, "H": cfg.d_model // cfg.rwkv_head_dim}
    got = {k: tp.is_block(f"tm_cm/{k}", p[k].shape[dim], whole[w], dist)
           for k, (dim, w) in _SPLIT_DIMS.items()}
    if len(set(got.values())) > 1:
        raise ValueError(f"tm_cm: blocks {sorted(k for k, v in got.items() if v)} beside whole "
                         f"{sorted(k for k, v in got.items() if not v)}")
    return got["wr"]


# the leaves a layer holds as this rank's FSDP blocks over the data axes
# (``specs.DATA_SPLIT_COMPUTE``): the dim of d each
_FSDP_DIMS = {"wr": 0, "wk": 0, "wv": 0, "wg": 0, "wo": -1, "decay_A": 0, "cm_k": 0,
              "cm_v": -1, "cm_r": 0}


def fsdp_split(cfg: ModelConfig, p: dict, dist=None) -> bool:
    """Whether the layer's leaves (one layer's, unstacked) are this rank's
    FSDP blocks over the data axes of ``dist.data_split``: its rows of
    ``wr``/``wk``/``wv``/``wg``/``decay_A``/``cm_k``/``cm_r`` and columns of
    ``wo``/``cm_v`` (all of them or none; anything else raises)."""
    got = {k: tp.is_data_block(f"tm_cm/{k} channels", p[k].shape[dim], cfg.d_model, dist)
           for k, dim in _FSDP_DIMS.items()}
    if len(set(got.values())) > 1:
        raise ValueError(f"tm_cm: FSDP blocks {sorted(k for k, v in got.items() if v)} beside "
                         f"whole {sorted(k for k, v in got.items() if not v)}")
    return got["wr"]


def _time_mix_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor, shifted: torch.Tensor,
                     split: bool = False, dist=None, data: bool = False):
    """r, k, v, g and log_w of the time-mix (B, S, d), or where ``split`` this
    rank's channels of each (its heads'): its columns of ``wr``/``wk``/``wv``/
    ``wg`` and ``decay_B``, its slice of ``w0``, and the decay's low-rank
    product over its rows of ``decay_A`` summed over the model axis.  ``x``
    and ``shifted`` are then already summing their gradients over it.  Where
    ``data`` (:func:`fsdp_split`), the mixes' rank's block of channels
    through its rows of ``decay_A``/``wr``/``wk``/``wv``/``wg``, the five
    partial sums all-reduced over the data axes at once."""
    mu = tp.copy_to_model(p["mu"], dist) if split else p["mu"]
    xf, sf = x.float(), shifted.float()
    mixed = xf[None] + (sf - xf)[None] * mu[:, None, None, :]  # (5, B, S, d)
    mw, mr, mk, mv, mg = mixed
    dt = x.dtype
    if data:
        parts = [tp.data_block(mw, dist) @ p["decay_A"]]
        parts += [tp.data_block(a.to(dt), dist) @ p[w]
                  for a, w in ((mr, "wr"), (mk, "wk"), (mv, "wv"), (mg, "wg"))]
        z, r, k, v, g = tp.reduce_from_data(parts, dist)
    elif split:
        decay_a = tp.model_block(p["decay_A"], 0, dist)
        _, rank, _ = tp.dist_group(dist)
        rows = decay_a.shape[0]
        z = tp.reduce_from_model(mw.narrow(-1, rank * rows, rows) @ decay_a, dist)
        z = tp.copy_to_model(z, dist)  # its consumer, decay_B's columns, is split
    else:
        z = mw @ p["decay_A"]
    if not data:
        r = mr.to(dt) @ p["wr"]
        k = mk.to(dt) @ p["wk"]
        v = mv.to(dt) @ p["wv"]
        g = mg.to(dt) @ p["wg"]
    w0 = tp.model_block(p["w0"], 0, dist) if split else p["w0"]
    log_w = -torch.exp(torch.clamp(w0 + torch.tanh(z) @ p["decay_B"], -8.0, 8.0))
    # (B, S, d) f32, < 0
    return r, k, v, F.silu(g), log_w


def _heads(cfg: ModelConfig, a: torch.Tensor) -> torch.Tensor:
    """(B, S, c) -> (B, S, c // K, K): all heads, or the rank's."""
    B, S, c = a.shape
    K = cfg.rwkv_head_dim
    return a.reshape(B, S, c // K, K)


def _bonus(cfg: ModelConfig, p: dict, split: bool, dist) -> torch.Tensor:
    """``u`` as (heads, K): all, or this rank's heads' slice."""
    u = tp.model_block(p["u"], 0, dist) if split else p["u"]
    return u.reshape(-1, cfg.rwkv_head_dim)


def _time_mix_out(p: dict, y: torch.Tensor, g: torch.Tensor, split: bool, dist,
                  data: bool = False) -> torch.Tensor:
    """The group-normed heads ``y`` (B, S, H, K) gated by ``g`` through
    ``wo``; row-parallel where ``split`` (the partial outputs summed); where
    ``data`` the rank's block of the output's channels, gathered over the
    data axes."""
    y = _group_norm(y, p["ln_scale"])
    out = (y.reshape(g.shape) * g) @ p["wo"]
    if split:
        out = tp.reduce_from_model(out, dist)
    return tp.gather_from_data(out, dist) if data else out


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
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, chunked: bool = True, dist=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-mix over the whole sequence; also returns the final WKV state
    (B, H, K, V) f32: of all heads, or with ``dist`` and this rank's blocks
    (:func:`tp_split`) of its heads."""
    split, data = tp_split(cfg, p, dist), fsdp_split(cfg, p, dist)
    if split:
        x = tp.copy_to_model(x, dist)
    r, k, v, g, log_w = _time_mix_inputs(cfg, p, x, _shift(x), split, dist, data)
    rh, kh, vh, lwh = (_heads(cfg, a) for a in (r, k, v, log_w))
    y, state = _wkv_dispatch(rh, kh, vh, lwh, _bonus(cfg, p, split, dist), chunked,
                             cfg.wkv_chunk)
    return _time_mix_out(p, y, g, split, dist, data), state


def rwkv_time_mix(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, chunked: bool = True, dist=None
) -> torch.Tensor:
    return rwkv_time_mix_prefill(cfg, p, x, chunked=chunked, dist=dist)[0]


def _channel_mix(p: dict, x: torch.Tensor, shifted: torch.Tensor, split: bool = False,
                 dist=None, data: bool = False) -> torch.Tensor:
    """sigmoid(mr @ cm_r) * (relu(mk @ cm_k)² @ cm_v); where ``split`` on this
    rank's FF block of ``cm_k``/``cm_v``, the partial outputs reduce-scattered
    over channels, gated there by the rank's columns of ``cm_r``, and
    gathered whole (``x`` and ``shifted`` already summing their gradients).
    Where ``data`` (:func:`fsdp_split`), ``cm_k`` and the gate's ``cm_r``
    contract over the rank's block of channels (one all-reduce over the data
    axes of both), and ``cm_v``'s block of output channels is gathered over
    them before the gate."""
    cmu = tp.copy_to_model(p["cmu"], dist) if split else p["cmu"]
    xf, sf = x.float(), shifted.float()
    mk = (xf + (sf - xf) * cmu[0]).to(x.dtype)
    mr = (xf + (sf - xf) * cmu[1]).to(x.dtype)
    cm_r = tp.model_block(p["cm_r"], 1, dist) if split else p["cm_r"]
    if data:
        kk, zr = tp.reduce_from_data([tp.data_block(mk, dist) @ p["cm_k"],
                                      tp.data_block(mr, dist) @ cm_r], dist)
    else:
        kk, zr = mk @ p["cm_k"], mr @ cm_r
    gate, kk = torch.sigmoid(zr), torch.square(F.relu(kk))
    value = kk @ p["cm_v"]
    if data:
        value = tp.gather_from_data(value, dist)
    if not split:
        return gate * value
    return tp.gather_from_model(gate * tp.scatter_to_model(value, dist), dist)


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, dist=None) -> torch.Tensor:
    split = tp_split(cfg, p, dist)
    if split:
        x = tp.copy_to_model(x, dist)
    return _channel_mix(p, x, _shift(x), split, dist, fsdp_split(cfg, p, dist))


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
    cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict, dist=None
) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d); updates cache['state'] and cache['tm_shift'] in place.
    With ``dist`` and this rank's blocks (:func:`tp_split`) the state is its
    heads' (B, H/n, K, V) and the shift whole."""
    split, data = tp_split(cfg, p, dist), fsdp_split(cfg, p, dist)
    r, k, v, g, log_w = _time_mix_inputs(cfg, p, x, cache["tm_shift"][:, None], split, dist,
                                         data)
    y, new_state = wkv_decode_step(*(_heads(cfg, a)[:, 0] for a in (r, k, v, log_w)),
                                   _bonus(cfg, p, split, dist), cache["state"])
    out = _time_mix_out(p, y[:, None], g, split, dist, data)
    cache["state"].copy_(new_state)
    cache["tm_shift"].copy_(x[:, 0])
    return out, cache


def rwkv_channel_mix_decode(
    cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict, dist=None
) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d); updates cache['cm_shift'] (whole) in place."""
    out = _channel_mix(p, x, cache["cm_shift"][:, None], tp_split(cfg, p, dist), dist,
                       fsdp_split(cfg, p, dist))
    cache["cm_shift"].copy_(x[:, 0])
    return out, cache

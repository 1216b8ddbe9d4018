"""Attention layers: GQA self-attention, cross-attention and decode against a
KV cache.

Ported from ``repro.models.attention``.  Heads stay in an explicit
(groups, heads-per-group) layout so GQA never repeats K/V.  Full-sequence
attention switches to a KV-chunked online softmax above ``CHUNK_THRESHOLD``
keys; with kernels on and Sq == Sk it goes to the flash kernel instead (the
dispatch ``repro.models.attention.attend`` makes).
Decode attention, which the JAX package leaves to plain jnp, goes with
kernels on to the decode-attention kernel where each query head reads its
own KV heads and the cache's sequence is whole (:func:`decode_attention`);
cross-attention stays plain torch, as does decode attention over picked KV
heads or a sequence chunk.  Given the rank's heads over the model axis
(``sharding.tp``), self- and cross-attention compute on them and end in one
all-reduce (:func:`tp_heads`).  Given also the rank's FSDP blocks over the
data axes (a decode step's ``DistContext.data_split``), self-attention's
projections contract over the rank's block of the input's channels and
``wo`` writes its block of the output's (:func:`qkv_proj`,
:func:`attn_out`), and decode attends over the rank's chunk of a cache
split over its sequence, its softmax combined over the data axes
(:func:`decode_attention`).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.config import kernels_enabled
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import NEG_INF, apply_rope, dense_init, dtype_of, softcap
from repro_torch.sharding import tp

CHUNK_THRESHOLD = 2048  # switch to chunked attention above this many keys
KV_CHUNK = 512


# --------------------------------------------------------------------------
# Parameters.
# --------------------------------------------------------------------------

def attn_params(cfg: ModelConfig, gen: torch.Generator, lead: Tuple[int, ...] = (),
                kv_input_dim: Optional[int] = None) -> dict:
    """QKV + output projection; ``lead`` prepends stacking axes.
    ``kv_input_dim`` overrides the K/V input width for cross-attention over
    frontend embeddings (llama-vision)."""
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kd = kv_input_dim or d
    dt = dtype_of(cfg)
    return {
        "wq": dense_init(gen, lead + (d, H, dh), dt, fan_in=d),
        "wk": dense_init(gen, lead + (kd, KV, dh), dt, fan_in=kd),
        "wv": dense_init(gen, lead + (kd, KV, dh), dt, fan_in=kd),
        "wo": dense_init(gen, lead + (H, dh, d), dt, fan_in=H * dh),
    }


def _split_groups(q: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, H, dh) -> (B, S, G, M, dh) with G kv heads, M = H // G: the
    head counts are the tensors', whole or this rank's blocks."""
    B, S, H, dh = q.shape
    return q.reshape(B, S, G, H // G, dh)


def _scale(cfg: ModelConfig) -> float:
    return cfg.head_dim_**-0.5


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, N, k) -> (B, S, N, k), contiguous (the kernel reads
    these buffers in place through strides)."""
    d, n, k = w.shape
    return (x @ w.reshape(d, n * k)).view(*x.shape[:-1], n, k)


# --------------------------------------------------------------------------
# Mask helpers.  Positions are absolute token indices; window==0 -> global.
# --------------------------------------------------------------------------

def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: int, causal: bool
) -> torch.Tensor:
    """(Sq, Sk) additive f32 bias: 0 where attendable, NEG_INF elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    ok &= k_pos[None, :] >= 0  # invalid / unwritten cache slots carry pos -1
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=q_pos.device)
    return bias.masked_fill_(~ok, NEG_INF)


# --------------------------------------------------------------------------
# Core attention on explicit K/V (dense and chunked paths).
# q: (B, Sq, G, M, dh); k, v: (B, Sk, G, dh).
# --------------------------------------------------------------------------

def _attend_dense(
    cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention over all of ``k``; ``bias`` (additive mask) or none."""
    logits = torch.einsum("bsgmd,btgd->bgmst", q.float(), k.float()) * _scale(cfg)
    logits = softcap(logits, cfg.attn_softcap)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bgmst,btgd->bsgmd", probs.to(v.dtype), v)


def _softmax_part(
    cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax attention's part over the keys of ``k``, one part of a key axis
    split in parts (``tp.merge_softmax``): the row maximum m (B, G, M, Sq),
    the sum l of exp(logit - m) and the unnormalised output o (B, G, M, Sq,
    dh), f32; the logits as :func:`_attend_dense` makes them.  Where every
    key is masked, m is near ``NEG_INF`` and the merge weighs the part 0."""
    logits = torch.einsum("bsgmd,btgd->bgmst", q.float(), k.float()) * _scale(cfg)
    logits = softcap(logits, cfg.attn_softcap) + bias
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bgmst,btgd->bgmsd", p.to(v.dtype), v).float()
    return m, p.sum(dim=-1), o


def _attend_chunked(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: int,
    causal: bool,
) -> torch.Tensor:
    """Online softmax over KV chunks (the flash recurrence in plain torch)."""
    B, Sq, G, M, dh = q.shape
    Sk = k.shape[1]
    n_chunks = -(-Sk // KV_CHUNK)
    pad = n_chunks * KV_CHUNK - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    qf = q.float() * _scale(cfg)
    m = torch.full((B, G, M, Sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, G, M, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, G, M, Sq, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * KV_CHUNK, (c + 1) * KV_CHUNK)
        logits = torch.einsum("bsgmd,btgd->bgmst", qf, k[:, sl].float())
        logits = softcap(logits, cfg.attn_softcap)
        logits = logits + _mask_bias(q_pos, k_pos[sl], window, causal)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows: keep m finite so exp() is well-defined
        m_safe = torch.clamp(m_new, min=-1e30)
        p = torch.exp(logits - m_safe[..., None])
        scale_old = torch.exp(torch.clamp(m, min=-1e30) - m_safe)
        l = l * scale_old + p.sum(dim=-1)
        acc = acc * scale_old[..., None] + torch.einsum(
            "bgmst,btgd->bgmsd", p, v[:, sl].float()
        )
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)  # (B, Sq, G, M, dh)


# --------------------------------------------------------------------------
# Public layer entry points.
# --------------------------------------------------------------------------

def _fsdp_split(cfg: ModelConfig, p: dict, dist, name: str = "attn") -> bool:
    """Whether ``p``'s weights are this rank's FSDP blocks over the data axes
    (``dist.data_split``): the rows of ``wq``/``wk``/``wv`` and the output
    channels of ``wo`` (all four or none; anything else raises).
    Cross-attention (``name`` ``xattn``) computes on weights whole over them
    and raises on blocks."""
    d = cfg.d_model
    keys = ("wq", "wk", "wv") if name == "attn" else ("wq",)
    got = {k: tp.is_data_block(f"{name}/{k} rows", p[k].shape[0], d, dist) for k in keys}
    got["wo"] = tp.is_data_block(f"{name}/wo columns", p["wo"].shape[-1], d, dist)
    if len(set(got.values())) > 1:
        raise ValueError(f"{name}: FSDP blocks {sorted(k for k, v in got.items() if v)} "
                         f"beside whole {sorted(k for k, v in got.items() if not v)}")
    if got["wo"] and name != "attn":
        raise ValueError(f"{name}: cross-attention computes on weights whole over the data "
                         "axes, not on their FSDP blocks")
    return got["wo"]


def qkv_proj(
    cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, dist=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + rope.  Returns q (B,S,H,dh), k, v (B,S,G,dh).  Where the
    weights are the rank's FSDP blocks (:func:`_fsdp_split`), the rank's
    block of x's channels through their rows, the three partial sums
    all-reduced over the data axes together."""
    names = ("wq", "wk", "wv")
    if _fsdp_split(cfg, p, dist):
        xb = tp.data_block(x, dist)
        q, k, v = tp.reduce_from_data([_project(xb, p[w]) for w in names], dist)
    else:
        q, k, v = (_project(x, p[w]) for w in names)
    if cfg.pos == "rope":
        q = apply_rope(q, positions[None], cfg.rope_theta)
        k = apply_rope(k, positions[None], cfg.rope_theta)
    return q, k, v


def attend(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, G, dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    *,
    window: int = 0,
    causal: bool = True,
) -> torch.Tensor:
    """Masked attention core; auto-chunks above CHUNK_THRESHOLD keys.
    Returns (B, Sq, H, dh).  With kernels enabled and Sq == Sk (contiguous
    positions from 0), dispatches to ``kernels.flash_attention.ops``."""
    B, Sq = q.shape[:2]
    if kernels_enabled() and Sq == k.shape[1]:
        return fa_ops.attention(
            q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap
        )
    qg = _split_groups(q, k.shape[2])
    if k.shape[1] > CHUNK_THRESHOLD:
        out = _attend_chunked(cfg, qg, k, v, q_pos, k_pos, window, causal)
    else:
        bias = _mask_bias(q_pos, k_pos, window, causal)
        out = _attend_dense(cfg, qg, k, v, bias)
    return out.reshape(q.shape)


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) @ (H, dh, d) -> (B, S, d)."""
    H, dh, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], H * dh) @ p["wo"].reshape(H * dh, d)


def _head_split(cfg: ModelConfig, p: dict, dist, name: str
                ) -> Tuple[bool, Optional[torch.Tensor]]:
    """(whether ``p``'s ``wq``/``wo`` are this rank's heads, the KV head each
    of them reads where ``wk``/``wv`` are whole beside them, else None);
    ``name`` (``attn``, ``xattn``) names the weights in an error."""
    split = tp.is_block(f"{name}/wq heads", p["wq"].shape[-2], cfg.n_heads, dist)
    if tp.is_block(f"{name}/wo heads", p["wo"].shape[0], cfg.n_heads, dist) != split:
        raise ValueError(f"{name}: wq {tuple(p['wq'].shape)} and wo {tuple(p['wo'].shape)} "
                         "are not both whole or both blocks")
    kv_split = tp.is_block(f"{name}/wk heads", p["wk"].shape[-2], cfg.n_kv_heads, dist)
    if kv_split and not split:
        raise ValueError(f"{name}: wk {tuple(p['wk'].shape)} is a block beside whole heads")
    if not split or kv_split:
        return split, None
    _, r, n = tp.dist_group(dist)
    H_l = cfg.n_heads // n
    heads = torch.arange(r * H_l, (r + 1) * H_l, device=p["wq"].device)
    return split, heads * cfg.n_kv_heads // cfg.n_heads


def _whole_kv(p: dict, sel: Optional[torch.Tensor], dist) -> dict:
    """``p`` with whole ``wk``/``wv`` that this rank's heads use in part
    (``sel`` given) summing their gradients over the model axis."""
    if sel is None:
        return p
    return dict(p, wk=tp.copy_to_model(p["wk"], dist), wv=tp.copy_to_model(p["wv"], dist))


def tp_heads(cfg: ModelConfig, p: dict, x: torch.Tensor, dist=None
             ) -> Tuple[dict, torch.Tensor, bool, Optional[torch.Tensor]]:
    """(the weights and the input to compute with, whether the weights are
    this rank's heads, the KV head each of its query heads reads where the
    KV heads are whole).

    ``wq``/``wo`` hold all H heads (every rank computes whole) or with
    ``dist`` the rank's H/n (heads [r·H/n, (r+1)·H/n) over the model axis of
    n).  Beside the rank's heads ``wk``/``wv`` hold the KV heads of the same
    range (G/n, aligned: head h reads group h·G/H) or, where G did not
    split, all G; then each query head's group is picked from them
    (returned), and the gradients of the whole ``wk``/``wv``, which each
    rank uses in part, are summed over the model axis; so are the input's,
    which each rank's heads use in part."""
    split, sel = _head_split(cfg, p, dist, "attn")
    if split:
        x = tp.copy_to_model(x, dist)
    return _whole_kv(p, sel, dist), x, split, sel


def kv_heads(t: torch.Tensor, sel: Optional[torch.Tensor]) -> torch.Tensor:
    """K or V (B, S, G, dh) for the query heads: as is, or one head a query
    head where ``sel`` picks them (:func:`tp_heads`)."""
    return t if sel is None else t.index_select(2, sel)


def attn_out(cfg: ModelConfig, p: dict, o: torch.Tensor, split: bool, dist=None
             ) -> torch.Tensor:
    """The output projection; over the model axis where ``split`` (the
    rank's heads' partial outputs summed); where ``wo`` is the rank's FSDP
    block over the data axes, its block of the output's channels, then
    gathered over them."""
    out = out_proj(p, o)
    if split:
        out = tp.reduce_from_model(out, dist)
    if tp.is_data_block("attn/wo columns", p["wo"].shape[-1], cfg.d_model, dist):
        out = tp.gather_from_data(out, dist)
    return out


def self_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,)
    *,
    window: int = 0,
    causal: bool = True,
    dist=None,
) -> torch.Tensor:
    """Full-sequence self-attention (prefill / training forward / encoder),
    on all heads or on this rank's (:func:`tp_heads`)."""
    p, x, split, sel = tp_heads(cfg, p, x, dist)
    q, k, v = qkv_proj(cfg, p, x, positions, dist)
    out = attend(cfg, q, kv_heads(k, sel), kv_heads(v, sel), positions, positions,
                 window=window, causal=causal)
    return attn_out(cfg, p, out, split, dist)


def cross_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (B, T, G, dh) pairs
    dist=None,
) -> torch.Tensor:
    """Cross-attention over precomputed K/V (encoder output / image patches).
    No positional rotation, no mask (all frontend tokens visible), and never
    the flash kernel, as in the JAX package.  On all heads, or on this
    rank's (as :func:`tp_heads`), ``kv`` then :func:`cross_kv`'s of the same
    weights: the rank's KV heads, or all G, from which each query head's is
    picked."""
    B, S, _ = x.shape
    _fsdp_split(cfg, p, dist, "xattn")
    split, sel = _head_split(cfg, p, dist, "xattn")
    if split:
        x = tp.copy_to_model(x, dist)
    k, v = (kv_heads(t, sel) for t in kv)
    qg = _split_groups(_project(x, p["wq"]), k.shape[2])
    T = k.shape[1]
    if T > CHUNK_THRESHOLD:
        zeros_q = torch.zeros((S,), dtype=torch.int32, device=x.device)
        zeros_k = torch.zeros((T,), dtype=torch.int32, device=x.device)
        out = _attend_chunked(cfg, qg, k, v, zeros_q, zeros_k, 0, causal=False)
    else:
        out = _attend_dense(cfg, qg, k, v)
    return attn_out(cfg, p, out.reshape(B, S, -1, cfg.head_dim_), split, dist)


def cross_kv(cfg: ModelConfig, p: dict, enc: torch.Tensor, dist=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, T, G, dh) from encoder / frontend states, on
    the KV heads of ``wk``/``wv``: all, or with ``dist`` this rank's block
    of them beside its query heads (``enc``'s gradient, which each rank's
    heads use in part, summed over the model axis; so are whole
    ``wk``/``wv``'s beside split query heads).  ``enc`` is cast to the
    weights' dtype first: the JAX package's einsum promotes a bf16 frontend
    to f32 weights the same way."""
    _fsdp_split(cfg, p, dist, "xattn")
    split, sel = _head_split(cfg, p, dist, "xattn")
    enc = enc.to(p["wk"].dtype)
    if split:
        enc = tp.copy_to_model(enc, dist)
    p = _whole_kv(p, sel, dist)
    return _project(enc, p["wk"]), _project(enc, p["wv"])


# --------------------------------------------------------------------------
# KV cache (decode).  Two layouts:
#   * global layers: capacity S_max, written at the absolute position;
#   * local (sliding-window) layers: a ring buffer of size ``window``.
# ``pos`` entries are absolute key positions (-1 = unwritten, masked out).
# --------------------------------------------------------------------------

def init_kv_cache(
    cfg: ModelConfig, batch: int, capacity: int, dtype=None, device=None
) -> dict:
    G, dh = cfg.n_kv_heads, cfg.head_dim_
    dt = dtype or dtype_of(cfg)
    return {
        "k": torch.zeros((batch, capacity, G, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, capacity, G, dh), dtype=dt, device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
    }


def cache_capacity(window: int, seq_len: int) -> int:
    return min(window, seq_len) if window else seq_len


def cache_from_kv(
    k: torch.Tensor,  # (B, S, G, dh) — rope already applied
    v: torch.Tensor,
    positions: torch.Tensor,  # (S,)
    capacity: int,
) -> dict:
    """Build a decode cache from prefill K/V: padded to ``capacity``, or, when
    the prompt is longer (sliding-window layers), the trailing ``capacity``
    positions in ring-buffer layout, slot = pos % capacity."""
    B, S, G, dh = k.shape
    if capacity < S:
        tail_pos = positions[-capacity:]
        order = torch.argsort(tail_pos % capacity)
        return {
            "k": k[:, -capacity:][:, order],
            "v": v[:, -capacity:][:, order],
            "pos": tail_pos[order],
        }
    cache = {
        "k": torch.zeros((B, capacity, G, dh), dtype=k.dtype, device=k.device),
        "v": torch.zeros((B, capacity, G, dh), dtype=v.dtype, device=v.device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=k.device),
    }
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    cache["pos"][:S] = positions
    return cache


def as_pos(pos: Union[int, torch.Tensor], device) -> torch.Tensor:
    """A decode position as the step takes it: a 0-d int32 tensor on
    ``device``.  An int is copied there once, before any capture."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.tensor(pos, dtype=torch.int32, device=device)


def decode_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    pos: Union[int, torch.Tensor],  # 0-d int32 (or int): position of the new token
    cache: dict,
    *,
    window: int = 0,
    dist=None,
) -> Tuple[torch.Tensor, dict]:
    """One-token self-attention against the KV cache.  Unlike the JAX
    package, which returns a new cache, this writes the new key, value and
    position into ``cache`` in place and returns the same dict.  The slot is
    picked on the device, as the JAX package's ``jnp.where`` picks it:
    ``pos % capacity`` in a ring (LOCAL), else ``min(pos, capacity - 1)``;
    nothing reads ``pos`` on the host.  With ``dist`` and this rank's heads
    (:func:`tp_heads`) the cache holds the KV heads of ``wk``: the rank's
    block of them, or all.

    With ``dist.data_split`` the projections run on the rank's FSDP blocks
    (:func:`qkv_proj`, :func:`attn_out`), and the cache's K/V (B, cap/n,
    G, dh) may be the rank's chunk of the sequence over the n data ranks
    (``pos`` (cap,) stays whole on every rank): the slot lies in one
    rank's chunk, so each rank writes the new K/V where its local slot,
    clamped into the chunk, is the slot and rewrites its old K/V there
    otherwise (picked on the device), attends over its chunk and combines
    its softmax with the other chunks' (``tp.combine_over_data``).

    Over a whole cache sequence the attention is the decode-attention
    kernel's plain version (``kernels.decode_attention.ref``), or with
    kernels on, where query heads read their own KV heads (no ``sel``),
    ``kernels.decode_attention.ops``: the kernel on the card, on the CPU the
    same plain version."""
    pos = as_pos(pos, x.device)
    p, x, split, sel = tp_heads(cfg, p, x, dist)
    pos_t = pos.view(1, 1)
    q, k_new, v_new = qkv_proj(cfg, p, x, pos_t[0], dist)

    capacity = cache["pos"].shape[0]
    chunked = tp.is_data_block("attn cache sequence", cache["k"].shape[1], capacity, dist)
    slot = pos % capacity if window > 0 else torch.clamp(pos, max=capacity - 1)
    slot = slot.view(1).long()
    cache["pos"].index_copy_(0, slot, pos.view(1))
    k_pos = cache["pos"]
    if chunked:
        _, r, _ = tp.data_group(dist)
        c = cache["k"].shape[1]
        local = slot - r * c
        mine = ((local >= 0) & (local < c)).view(1, 1, 1, 1)
        local = local.clamp(0, c - 1)
        k_pos = k_pos.narrow(0, r * c, c)
        for key, new in (("k", k_new), ("v", v_new)):
            old = cache[key].index_select(1, local)
            cache[key].index_copy_(1, local, torch.where(mine, new, old))
    else:
        cache["k"].index_copy_(1, slot, k_new)
        cache["v"].index_copy_(1, slot, v_new)

    k, v = kv_heads(cache["k"], sel), kv_heads(cache["v"], sel)
    if chunked:
        qg = _split_groups(q, k.shape[2])  # (B, 1, G, M, dh)
        bias = _mask_bias(pos_t[0], k_pos, window, causal=True)
        out = tp.combine_over_data(*_softmax_part(cfg, qg, k, v, bias), dist)
        out = out.permute(0, 3, 1, 2, 4).to(v.dtype)  # (B, 1, G, M, dh)
    else:
        attend = da_ops.decode_attention if kernels_enabled() and sel is None \
            else decode_attention_ref
        out = attend(q[:, 0], k, v, k_pos, pos, window=window, softcap=cfg.attn_softcap,
                     scale=_scale(cfg))
    return attn_out(cfg, p, out.reshape(q.shape), split, dist), cache

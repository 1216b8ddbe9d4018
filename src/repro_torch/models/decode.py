"""Serving entry points: cache init, prefill and single-token decode.

Ported from ``repro.models.decode`` for ATTN, LOCAL, RWKV and RGLRU layers.
Caches mirror the parameter structure: one tuple per layer group, one dict
per layer kind of the group's pattern, leaves stacked over the group's
``count``: a KV cache for ATTN; a ring-buffer KV cache of capacity
``min(window, capacity)`` for LOCAL (O(1) in context length); the O(1)
recurrent state and the two token shifts for RWKV; the recurrence state and
the conv tail for RGLRU.  A Python loop over the stack replaces
``lax.scan``.  Decode writes each new key and value, or the new states and
shifts, into the stacked cache in place (through per-layer views) and hands
back the same cache object; the JAX package returns a new one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, LOCAL, RGLRU, RWKV, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import griffin, rwkv
from repro_torch.models.common import apply_norm, mlp_apply, unembed
from repro_torch.models.transformer import (
    _embed_tokens,
    _positions_embed,
    check_supported,
    layer_params,
)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int, device) -> dict:
    if kind == ATTN:
        return attn.init_kv_cache(cfg, batch, capacity, device=device)
    if kind == LOCAL:
        return attn.init_kv_cache(cfg, batch, attn.cache_capacity(cfg.window, capacity),
                                  device=device)
    if kind == RWKV:
        return rwkv.init_rwkv_cache(cfg, batch, device=device)
    if kind == RGLRU:
        return griffin.init_rglru_cache(cfg, batch, device=device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, device=None) -> tuple:
    """Empty caches for every group, stacked over the group's count."""
    check_supported(cfg)
    groups = []
    for g in cfg.groups:
        single = [_layer_cache(cfg, kind, batch, capacity, device) for kind in g.pattern]
        groups.append(tuple(
            {k: t.unsqueeze(0).repeat(g.count, *([1] * t.dim())) for k, t in c.items()}
            for c in single
        ))
    return tuple(groups)


def _stack(per_rep: list) -> tuple:
    """[rep][kind] -> (kind) of dicts with leaves stacked over rep."""
    return tuple(
        {key: torch.stack([rep[j][key] for rep in per_rep]) for key in per_rep[0][j]}
        for j in range(len(per_rep[0]))
    )


def _prefill_layer(
    cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, positions: torch.Tensor,
    capacity: int,
) -> Tuple[torch.Tensor, dict]:
    if kind in (ATTN, LOCAL):
        window = cfg.window if kind == LOCAL else 0
        h = apply_norm(cfg, x, p["ln1"])
        q, k, v = attn.qkv_proj(cfg, p["attn"], h, positions)
        cap = capacity if kind == ATTN else attn.cache_capacity(cfg.window, capacity)
        cache = attn.cache_from_kv(k, v, positions, cap)
        o = attn.attend(cfg, q, k, v, positions, positions, window=window)
        x = x + attn.out_proj(p["attn"], o)
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h), cache
    if kind == RWKV:
        h = apply_norm(cfg, x, p["ln1"])
        y, state = rwkv.rwkv_time_mix_prefill(cfg, p["tm_cm"], h)
        x = x + y
        h2 = apply_norm(cfg, x, p["ln2"])
        x = x + rwkv.rwkv_channel_mix(cfg, p["tm_cm"], h2)
        # the shifts are the last position's normed inputs, not x
        return x, {"state": state, "tm_shift": h[:, -1], "cm_shift": h2[:, -1]}
    if kind == RGLRU:
        h = apply_norm(cfg, x, p["ln1"])
        y, cache = griffin.rglru_block_prefill(cfg, p["rec"], h)
        x = x + y
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h), cache
    raise ValueError(kind)


def prefill(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S)
    *,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, tuple]:
    """Returns (logits of the last position (B, V) f32, caches)."""
    check_supported(cfg)
    S = tokens.shape[1]
    capacity = capacity or S
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed_tokens(cfg, params, tokens)
    x = _positions_embed(cfg, params, x, positions)

    caches = []
    for group, gp in zip(cfg.groups, params["groups"]):
        per_rep = []
        for i in range(group.count):
            outs = []
            for kind, p in zip(group.pattern, layer_params(gp, i)):
                x, c = _prefill_layer(cfg, kind, p, x, positions, capacity)
                outs.append(c)
            per_rep.append(outs)
        caches.append(_stack(per_rep))

    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x[:, -1]), tuple(caches)


def _decode_layer(
    cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, pos: int, cache: dict
) -> torch.Tensor:
    if kind in (ATTN, LOCAL):
        h = apply_norm(cfg, x, p["ln1"])
        a, _ = attn.decode_attention(cfg, p["attn"], h, pos, cache,
                                     window=cfg.window if kind == LOCAL else 0)
        x = x + a
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h)
    if kind == RWKV:
        h = apply_norm(cfg, x, p["ln1"])
        y, _ = rwkv.rwkv_time_mix_decode(cfg, p["tm_cm"], h, cache)
        x = x + y
        h2 = apply_norm(cfg, x, p["ln2"])
        y2, _ = rwkv.rwkv_channel_mix_decode(cfg, p["tm_cm"], h2, cache)
        return x + y2
    if kind == RGLRU:
        h = apply_norm(cfg, x, p["ln1"])
        y, _ = griffin.rglru_block_decode(cfg, p["rec"], h, cache)
        x = x + y
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h)
    raise ValueError(kind)


def decode_step(
    cfg: ModelConfig,
    params: dict,
    caches: tuple,
    token: torch.Tensor,  # (B, 1)
    pos: int,  # absolute position of this token
) -> Tuple[torch.Tensor, tuple]:
    """Returns (logits (B, V) f32, caches) with ``caches`` updated in place."""
    pos = int(pos)
    x = _embed_tokens(cfg, params, token)
    if cfg.pos == "learned":
        x = _positions_embed(cfg, params, x, torch.tensor([pos], device=token.device))
    for group, gp, gc in zip(cfg.groups, params["groups"], caches):
        for i in range(group.count):
            for kind, p, c in zip(group.pattern, layer_params(gp, i), layer_params(gc, i)):
                x = _decode_layer(cfg, kind, p, x, pos, c)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x[:, -1]), caches

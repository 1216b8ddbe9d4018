"""The model: layer groups applied over parameters stacked per group.

Ported from ``repro.models.transformer`` for ATTN, LOCAL, RWKV and RGLRU
layers, with or without post-norms (gemma2), on one device (``dist=None``).
The parameter tree keeps the JAX package's keys and its stacking over a
group's ``count`` (``_superblock_params``), so a JAX tree carried across by
``convert.params_from_jax`` runs here unchanged; the layer loop replaces
``lax.scan`` over the stack.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.configs.base import ATTN, LOCAL, RGLRU, RWKV, LayerGroup, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import griffin, rwkv
from repro_torch.models.common import (
    apply_norm,
    dtype_of,
    embed_params,
    gemma_forms,
    mlp_apply,
    mlp_params,
    unembed,
)


PORTED_KINDS = (ATTN, LOCAL, RWKV, RGLRU)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs dense decoders whose layers are any mix of the ported
    kinds, with or without post-norms (no MoE, encoder, or cross-attention
    layers)."""
    kinds = {k for g in cfg.groups for k in g.pattern}
    if not kinds <= set(PORTED_KINDS) or cfg.is_moe or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}; the port runs decoders whose "
            f"layers are each one of {PORTED_KINDS} (dense, no encoder)")


# --------------------------------------------------------------------------
# Parameter init: same keys, shapes, dtypes and std as the JAX package.
# --------------------------------------------------------------------------

def norm_params(cfg: ModelConfig, lead: Tuple[int, ...], device) -> dict:
    if cfg.norm == "nonparam_ln":
        return None
    # the gemma forms' (1 + scale) RMSNorm starts from scale 0
    fill = 0.0 if cfg.norm == "rmsnorm" and gemma_forms(cfg) else 1.0
    p = {"scale": torch.full(lead + (cfg.d_model,), fill, dtype=dtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype_of(cfg), device=device)
    return p


def _layer_params(cfg: ModelConfig, kind: str, gen: torch.Generator, lead: Tuple[int, ...]) -> dict:
    p = {"ln1": norm_params(cfg, lead, gen.device), "ln2": norm_params(cfg, lead, gen.device)}
    if kind in (ATTN, LOCAL):
        p["attn"] = attn.attn_params(cfg, gen, lead)
        p["mlp"] = mlp_params(cfg, gen, lead)
        if cfg.post_norms:
            p["post_ln1"] = norm_params(cfg, lead, gen.device)
            p["post_ln2"] = norm_params(cfg, lead, gen.device)
    elif kind == RWKV:
        p["tm_cm"] = rwkv.rwkv_params(cfg, gen, lead)
    elif kind == RGLRU:
        p["rec"] = griffin.rglru_params(cfg, gen, lead)
        p["mlp"] = mlp_params(cfg, gen, lead)
    else:
        raise ValueError(kind)
    return p


def _superblock_params(cfg: ModelConfig, group: LayerGroup, gen: torch.Generator) -> tuple:
    """One dict per layer kind of the pattern, leaves stacked over ``count``."""
    return tuple(_layer_params(cfg, kind, gen, (group.count,)) for kind in group.pattern)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights on ``gen``'s device."""
    check_supported(cfg)
    return {
        "embed": embed_params(cfg, gen),
        "groups": tuple(_superblock_params(cfg, g, gen) for g in cfg.groups),
        "final_norm": norm_params(cfg, (), gen.device),
    }


def _take(tree, i: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(gp: tuple, i: int) -> tuple:
    """Repetition ``i`` of a group's stacked parameters (or caches), as views:
    one dict per layer kind of the pattern."""
    return tuple(_take(p, i) for p in gp)


# --------------------------------------------------------------------------
# Forward (full sequence).
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype`` first, as the JAX package casts it,
    as a host number: multiplying by it rounds as multiplying by a 0-d tensor
    of ``dtype`` does, and no step copies it to the device."""
    return float(torch.tensor(d_model**0.5, dtype=dtype))


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["tok"][tokens]
    if gemma_forms(cfg):
        x = x * _embed_scale(cfg.d_model, x.dtype)
    return x


def _positions_embed(cfg: ModelConfig, params: dict, x: torch.Tensor, positions) -> torch.Tensor:
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"][positions]
    return x


def post_norm(cfg: ModelConfig, p: dict, key: str, y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output through its post-norm (``post_ln1`` after
    attention, ``post_ln2`` after the MLP) where the config has them."""
    return apply_norm(cfg, y, p[key]) if cfg.post_norms else y


def _apply_layer_full(
    cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    if kind in (ATTN, LOCAL):
        h = apply_norm(cfg, x, p["ln1"])
        a = attn.self_attention(
            cfg, p["attn"], h, positions, window=cfg.window if kind == LOCAL else 0
        )
        x = x + post_norm(cfg, p, "post_ln1", a)
        h = apply_norm(cfg, x, p["ln2"])
        return x + post_norm(cfg, p, "post_ln2", mlp_apply(cfg, p["mlp"], h))
    if kind == RWKV:
        h = apply_norm(cfg, x, p["ln1"])
        x = x + rwkv.rwkv_time_mix(cfg, p["tm_cm"], h)
        h = apply_norm(cfg, x, p["ln2"])
        return x + rwkv.rwkv_channel_mix(cfg, p["tm_cm"], h)
    if kind == RGLRU:
        h = apply_norm(cfg, x, p["ln1"])
        x = x + griffin.rglru_block(cfg, p["rec"], h)
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h)
    raise ValueError(kind)


def forward(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) f32, aux_loss scalar); the aux loss is the
    MoE router's, zero for the dense layers ported so far."""
    check_supported(cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed_tokens(cfg, params, tokens)
    x = _positions_embed(cfg, params, x, positions)
    for group, gp in zip(cfg.groups, params["groups"]):
        for i in range(group.count):
            for kind, p in zip(group.pattern, layer_params(gp, i)):
                x = _apply_layer_full(cfg, kind, p, x, positions)
    x = apply_norm(cfg, x, params["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params["embed"], x), aux

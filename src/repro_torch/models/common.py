"""Shared building blocks: norms, activations, RoPE, init, MLP, embeddings.

Ported from ``repro.models.common``.  Norms compute in f32 and cast back to
the input dtype, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import tp


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def gemma_forms(cfg: ModelConfig) -> bool:
    """Whether the model takes the gemma family's forms: the ``(1 + scale)``
    RMSNorm with its scales initialised to 0, and the token embedding scaled
    by sqrt(d_model).  The port's one counterpart of the JAX package's
    ``"gemma" in cfg.name`` tests (its ``apply_norm``, ``norm_params`` and
    ``_embed_tokens``); the config schema stays an exact copy of JAX's."""
    return "gemma" in cfg.name


# --------------------------------------------------------------------------
# Norms.
# --------------------------------------------------------------------------

def rmsnorm(
    x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6, plus_one: bool = False
) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        s = scale.float()
        y = y * (1.0 + s) if plus_one else y * s
    return y.to(x.dtype)


def layernorm(
    x: torch.Tensor, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor, p: Optional[dict]) -> torch.Tensor:
    """Dispatch on cfg.norm.  ``p`` holds {'scale': ..., 'bias': ...} or is
    None for the non-parametric LN."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, None if p is None else p.get("scale"), plus_one=gemma_forms(cfg))
    if cfg.norm == "layernorm":
        return layernorm(
            x, None if p is None else p.get("scale"), None if p is None else p.get("bias")
        )
    if cfg.norm == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


# --------------------------------------------------------------------------
# Activations / softcap.
# --------------------------------------------------------------------------

def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(cfg.act)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# Rotary position embeddings (split-half layout).
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (dh/2,)
    ang = positions[..., None].float() * freqs  # (..., S, dh/2), in f32
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Init / MLP / embeddings.  Same shapes, dtypes and std as the JAX package;
# the values come from a torch.Generator, so they differ from JAX's.
# --------------------------------------------------------------------------

def dense_init(
    gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype, fan_in: int
) -> torch.Tensor:
    """Normal(0, 1/fan_in) in f32, cast to ``dtype``, on the generator's device
    (``META_GEN`` gives the shape and dtype on the meta device, drawing
    nothing)."""
    std = 1.0 / max(fan_in, 1) ** 0.5
    w = torch.randn(shape, generator=real_generator(gen), dtype=torch.float32,
                    device=gen.device)
    return w.mul_(std).to(dtype)  # in place: one f32 temporary of the shape, not two


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted:
    torch has no generator on the meta device."""

    device = torch.device("meta")


META_GEN = _MetaGenerator()


def real_generator(gen) -> Optional[torch.Generator]:
    """``gen``, or None for ``META_GEN`` (a meta draw needs no generator)."""
    return None if gen is META_GEN else gen


def mlp_params(cfg: ModelConfig, gen: torch.Generator, lead: Tuple[int, ...] = ()) -> dict:
    """``lead`` prepends stacking axes (a layer group's count)."""
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    w_in_cols = 2 * ff if cfg.gated else ff
    return {
        "w_in": dense_init(gen, lead + (d, w_in_cols), dt, fan_in=d),
        "w_out": dense_init(gen, lead + (ff, d), dt, fan_in=ff),
    }


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, dist=None) -> torch.Tensor:
    """The MLP on whole weights, or with ``dist`` on this rank's FF block:
    ``w_in``'s columns (a gated one in compute layout, the rank's gate
    columns beside the same up columns: ``ComputeSharding``) and the same
    rows of ``w_out``, the partial outputs summed over the model axis."""
    split = tp.is_block("mlp/w_out rows", p["w_out"].shape[0], cfg.d_ff, dist)
    cols = 2 * cfg.d_ff if cfg.gated else cfg.d_ff
    if tp.is_block("mlp/w_in columns", p["w_in"].shape[-1], cols, dist) != split:
        raise ValueError(f"mlp: w_in {tuple(p['w_in'].shape)} and w_out "
                         f"{tuple(p['w_out'].shape)} are not both whole or both blocks")
    if split:
        x = tp.copy_to_model(x, dist)
    h = x @ p["w_in"]
    if cfg.gated:
        gate, up = h.chunk(2, dim=-1)
        h = activation(cfg, gate) * up
    else:
        h = activation(cfg, h)
    out = h @ p["w_out"]
    return tp.reduce_from_model(out, dist) if split else out


def embed_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    p = {"tok": dense_init(gen, (cfg.vocab_padded, cfg.d_model), dt, fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_padded), dt, fan_in=cfg.d_model)
    if cfg.pos == "learned":
        p["pos"] = dense_init(gen, (65536, cfg.d_model), dt, fan_in=cfg.d_model)
    return p


def unembed(cfg: ModelConfig, embed: dict, x: torch.Tensor, dist=None) -> torch.Tensor:
    """Logits in f32 (tied head reads the embedding table): over the whole
    vocabulary, or with ``dist`` over this rank's block of it where the
    table is the rank's block."""
    table = embed["tok"].T if cfg.tie_embeddings else embed["head"]
    if tp.is_block("unembedding vocabulary", table.shape[-1], cfg.vocab_padded, dist):
        x = tp.copy_to_model(x, dist)
    return softcap((x @ table).float(), cfg.logit_softcap)

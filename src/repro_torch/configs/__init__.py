"""Architecture registry of the port: the JAX package's ten configurations.

``get_config(name)`` returns the published config; ``smoke_config(name)``
the reduced same-family config for CPU tests, reduced exactly as the JAX
package's ``repro.configs.smoke_config`` reduces it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (
    ATTN,
    ATTNX,
    SHAPES,
    XATTN,
    LayerGroup,
    ModelConfig,
    ShapeConfig,
)
from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN1_5_7B
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.llama3_2_vision_11b import CONFIG as LLAMA3_2_VISION_11B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.olmo_1b import CONFIG as OLMO_1B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6_1_6B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [LLAMA3_2_1B, RWKV6_1_6B, RECURRENTGEMMA_9B, OLMO_1B,
                        CODEQWEN1_5_7B, GEMMA2_9B, WHISPER_SMALL, LLAMA3_2_VISION_11B,
                        MIXTRAL_8X22B, DBRX_132B]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, identical layer pattern."""
    cfg = get_config(name)
    groups = tuple(
        LayerGroup(pattern=g.pattern, count=min(g.count, 2)) for g in cfg.groups
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        head_dim=32,
        vocab_size=512,
        groups=groups,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 32) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 24) if cfg.frontend_tokens else 0,
        frontend_dim=64 if cfg.frontend_dim else 0,
        lru_width=128 if cfg.lru_width else 0,
    )


__all__ = ["ARCHS", "ATTN", "ATTNX", "SHAPES", "XATTN", "LayerGroup", "ModelConfig",
           "ShapeConfig", "get_config", "smoke_config"]

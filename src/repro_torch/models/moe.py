"""Mixture-of-Experts layer on one device: top-k routing and the dense path.

Ported from ``repro.models.moe`` (``moe_params``, ``_route``,
``moe_apply_dense``).  ``moe_params`` draws one virtual expert an
expert: ``w_in`` (E, d, 2·ff), ``w_out`` (E, ff, d).  ``moe_apply_dense``
also takes the JAX package's virtual-expert layout with
each expert's FF width split into r shards (its ``init_params(ep_shards=r)``),
so those trees load 1:1: virtual expert j is (expert j // r, ff-shard j % r),
``w_in`` is (E·r, d, 2·ff/r), ``w_out`` (E·r, ff/r, d), r is read from the
shapes, and the r partial outputs of an expert are summed.  The router is f32
whatever the model dtype.

``moe_apply_dense`` runs every token through every virtual expert, as the
reference's single-device path does, and weights the outputs by the top-k
gates: E / top_k times the products a routed path needs, and no token is
dropped.  Every step stays on the device (no host read of a routing
decision), so a decode step that holds the layer can be captured in a CUDA
graph.  The expert-parallel path (capacity buckets and the all-to-all,
``moe_apply_sharded_inner``) is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, dtype_of


def _stacked_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
                  fan_in: int) -> torch.Tensor:
    """``dense_init`` of ``shape`` drawn one trailing matrix at a time into a
    tensor of ``dtype``: the f32 draw of a whole stack at once (51.5 GB for
    mixtral-8x22b's ``w_in`` over 8 layers) would not fit beside the
    weights on one card."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for m in out.view(-1, *shape[-2:]):
        m.copy_(dense_init(gen, shape[-2:], dtype, fan_in=fan_in))
    return out


def moe_params(cfg: ModelConfig, gen: torch.Generator, lead: Tuple[int, ...] = ()) -> dict:
    """The JAX package's keys, shapes, dtypes and std; ``lead`` prepends
    stacking axes (a layer group's count)."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "router": dense_init(gen, lead + (d, E), torch.float32, fan_in=d),
        "w_in": _stacked_init(gen, lead + (E, d, 2 * ff), dt, fan_in=d),
        "w_out": _stacked_init(gen, lead + (E, ff, d), dt, fan_in=ff),
    }


def _route(cfg: ModelConfig, router_w: torch.Tensor,
           x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x: (T, d) -> (gates (T, k) in x's dtype, idx (T, k),
    aux loss (f32 scalar))."""
    logits = x.float() @ router_w.float()  # (T, E), in f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)  # renormalise
    # load-balance aux loss (Switch/Mixtral form): E * sum_e(mean prob_e * top-1 share_e)
    E = cfg.n_experts
    me = probs.mean(dim=0)
    experts = torch.arange(E, device=x.device)
    ce = (idx[:, :1] == experts).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates.to(x.dtype), idx, aux


def moe_apply_dense(cfg: ModelConfig, p: dict,
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    gates, idx, aux = _route(cfg, p["router"], xt)
    E = cfg.n_experts
    r = p["w_in"].shape[0] // E  # the virtual layout is recorded in the shapes
    h = torch.matmul(xt, p["w_in"])  # (E·r, T, 2 ff/r)
    gate_h, up_h = h.chunk(2, dim=-1)
    h = activation(cfg, gate_h) * up_h
    outs = torch.matmul(h, p["w_out"])  # (E·r, T, d) partials
    outs = outs.reshape(E, r, T, d).sum(dim=1)  # (E, T, d): each expert's output
    # combine with the top-k gates: weight[t, idx[t, j]] += gates[t, j]
    weight = torch.zeros((T, E), dtype=x.dtype, device=x.device).scatter_add_(1, idx, gates)
    y = torch.einsum("te,etd->td", weight, outs)
    return y.reshape(B, S, d), aux

"""AdamW with decoupled weight decay and global-norm clipping, ported from
``repro.optim.adamw``.

Moments are f32 whatever the parameters' dtype, the update is computed in
f32 and cast back to each parameter's dtype, and decay applies to every
leaf (norm scales and embeddings too), as in the JAX package.
``torch.optim.AdamW`` is not used: it keeps bf16 moments for bf16
parameters.  Trees are the port's parameter trees (dicts and tuples, a
non-parametric norm's None stays None); leaves are visited in the JAX
package's order (``tree_leaves``), so sums over leaves add in its order.
``apply_updates`` writes the new parameters, moments and step count into
their tensors in place, under ``torch.no_grad()``, and returns the same
trees and state (the JAX package returns new ones).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.convert import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32: updates applied so far
    mu: Any  # first moment, f32, params-shaped
    nu: Any  # second moment, f32, params-shaped


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params) -> AdamWState:
    leaf = next(iter(tree_leaves(params)))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the f32 sum of squares over ``leaves``, summed in their order."""
    total = 0.0
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Gradients scaled by min(1, max_norm / max(norm, 1e-9)) in f32 and cast
    back to their dtypes; returns them and the norm before clipping.
    ``norm`` defaults to ``global_norm(grads)``; a sharded step gives the
    norm of the whole gradient, which its blocks alone do not hold."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads], norm


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params,
    grads: List[torch.Tensor],  # one for each leaf of params, in tree_leaves order
    state: AdamWState,
    lr: Optional[torch.Tensor] = None,
) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place: ``params``, ``state.mu``, ``state.nu`` and
    ``state.step`` are updated.  ``lr`` overrides cfg.lr (schedule hook)."""
    lr = cfg.lr if lr is None else lr
    step = state.step.add_(1)
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    for p, g, m, v in zip(tree_leaves(params), grads, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        gf = g.to(torch.float32)
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(gf))
        pf = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, state

"""Carry parameter trees from the JAX package into the port.

``params_from_jax`` takes the JAX tree with every leaf already a numpy array
(the caller runs ``jax.tree.map(np.asarray, params)``; this module imports
no JAX) and returns the same dict/tuple structure with torch leaves.  numpy
has no native bfloat16: a bf16 leaf (ml_dtypes) goes through float32, which
holds every bf16 value exactly, and back to ``torch.bfloat16``, so the
conversion is bit-exact.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a dict/tuple/list tree (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def array_to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's buffers are read-only


def params_from_jax(tree, device="cpu"):
    """numpy tree (JAX package layout) -> torch tree on ``device``."""
    return tree_map(lambda a: array_to_torch(a, device), tree)


def draw_xattn_gates(params: dict, rng: np.random.Generator, leaf: Callable = np.asarray) -> int:
    """Every XATTN layer's ``gate_attn`` and ``gate_mlp`` (0-d a layer,
    stacked over the group's count) to values in ±[0.3, 1.0) from ``rng``,
    in place, each f32 array made a leaf by ``leaf`` (the array itself for
    a tree in the JAX package's layout, ``torch.from_numpy`` and a move for
    the port's).  The gates start at zero, where tanh(0) = 0 and the layer
    adds nothing, so a parity check draws them first.  Returns how many gate
    arrays were set."""
    n = 0
    for layer in (layer for group in params["groups"] for layer in group):
        for key in ("gate_attn", "gate_mlp"):
            if key in layer:
                shape = tuple(layer[key].shape)
                mag = rng.uniform(0.3, 1.0, shape)
                layer[key] = leaf((mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32))
                n += 1
    return n

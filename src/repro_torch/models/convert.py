"""Carry parameter trees from the JAX package into the port, and the
port's tree helpers.

``params_from_jax`` takes the JAX tree with every leaf already a numpy array
(the caller runs ``jax.tree.map(np.asarray, params)``; this module imports
no JAX) and returns the same dict/tuple structure with torch leaves.  numpy
has no native bfloat16: a bf16 leaf (ml_dtypes) goes through float32, which
holds every bf16 value exactly, and back to ``torch.bfloat16``, so the
conversion is bit-exact.  ``opt_state_from_jax`` carries an AdamW state the
same way.  A tree is dicts, tuples, lists and NamedTuples over tensor
leaves, a None standing for no leaf (a non-parametric norm's parameters),
as in JAX's pytrees.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_map2(fn: Callable, a, b):
    """``fn(a_leaf, b_leaf)`` over two trees of one structure (``a``'s None
    stays None)."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(tree_map2(fn, x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    if a is None:
        return None
    return fn(a, b)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted, sequences and NamedTuple
    fields in order, None skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    ``tree_leaves`` order."""
    return _unflatten(like, iter(leaves))


def _unflatten(like, it):
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    if like is None:
        return None
    return next(it)


def array_to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's buffers are read-only


def params_from_jax(tree, device="cpu"):
    """numpy tree (JAX package layout) -> torch tree on ``device``."""
    return tree_map(lambda a: array_to_torch(a, device), tree)


def opt_state_from_jax(state, device="cpu"):
    """numpy AdamW state (the JAX package's ``AdamWState``) -> the port's,
    on ``device``: ``step``, ``mu`` and ``nu`` bit for bit."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=array_to_torch(state.step, device),
                      mu=params_from_jax(state.mu, device),
                      nu=params_from_jax(state.nu, device))


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

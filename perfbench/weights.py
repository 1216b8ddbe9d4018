"""The benchmark's weights: drawn on the device from the seed, in the
parameter layout the port takes and in the dtype it serves in.

The layout is the model's, not the program's: the configuration's own
module (``perfbench/reference/<name>.py``, found by ``Spec.reference``)
writes it out from the configuration file's ``model`` section as its
``layout(model)``, a list of leaves (``Leaf``), and names in
``absent(model)`` the paths the port holds as None.  Nothing here depends
on the model: a new configuration adds its layout to its own module.
Every leaf of one dtype is a view of one buffer filled by a few large
``normal_`` calls of a generator on the device, then scaled in place a leaf
at a time: by its std, or set to 1 where the std is None (a norm's scale).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

DRAW_CHUNK = 1 << 30  # elements a normal_ call
# one spec a leaf: (path, shape, dtype, std) with std None for a norm's ones
Leaf = Tuple[Tuple, Tuple[int, ...], torch.dtype, object]


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose (``tags``) of a run's seed: the same
    seed and tags give the same number."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]
    for t in tags:
        words.extend(t.encode() if isinstance(t, str) else [int(t) & 0xFFFFFFFF])
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> 1)


def nbytes(leaves: List[Leaf]) -> int:
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for _, shape, dt, _ in leaves)


def _put(tree: dict, path: Tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _as_tuples(node):
    """Dicts keyed by integers (groups, kinds) become tuples, in key order."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            return tuple(_as_tuples(node[k]) for k in sorted(node))
        return {k: _as_tuples(v) for k, v in node.items()}
    return node


def draw(reference, model: dict, seed: int, device) -> dict:
    """The weights of ``model`` from ``seed`` on ``device``, in the layout
    of its module ``reference``."""
    device = torch.device(device)
    leaves = reference.layout(model)
    by_dtype: Dict[torch.dtype, List[Leaf]] = {}
    for leaf in leaves:
        by_dtype.setdefault(leaf[2], []).append(leaf)
    tree: dict = {}
    for dt, group in by_dtype.items():
        total = sum(math.prod(shape) for _, shape, _, _ in group)
        flat = torch.empty(total, dtype=dt, device=device)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", str(dt)))
        for start in range(0, total, DRAW_CHUNK):
            flat[start:start + DRAW_CHUNK].normal_(generator=gen)
        offset = 0
        for path, shape, _, std in group:
            size = math.prod(shape)
            leaf = flat[offset:offset + size].view(shape)
            offset += size
            if std is None:
                leaf.fill_(1.0)
            else:
                leaf.mul_(std)
            _put(tree, path, leaf)
    for path in reference.absent(model):
        _put(tree, path, None)
    return _as_tuples(tree)

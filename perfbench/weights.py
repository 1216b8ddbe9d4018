"""The benchmark's weights: drawn on the device from the seed, in the
parameter layout the port takes and in the dtype it serves in.

The layout (``layout``) is written out here from a configuration file's
``model`` section, not read from the program: an ``embed`` dict (``tok``,
and ``head`` unless tied), ``groups`` (one tuple a layer group, one dict a
layer kind of its pattern, every leaf stacked over the group's count) and
``final_norm``.  Matrices are normal with std 1/sqrt(fan-in), the port's
own init; norm scales are 1; the router is float32.  Every leaf of one dtype
is a view of one buffer filled by a few large ``normal_`` calls of a
generator on the device, then scaled in place a leaf at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.work.serve import head_dim, vocab_rows

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
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


def layout(model: dict) -> List[Leaf]:
    """Every leaf of the port's parameter tree for this model."""
    dt = DTYPES[model.get("dtype", "bfloat16")]
    d, H, G, dh = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    ff, V = model["d_ff"], vocab_rows(model)
    gated = model.get("gated", True)
    leaves: List[Leaf] = [(("embed", "tok"), (V, d), dt, d ** -0.5)]
    if not model.get("tie_embeddings"):
        leaves.append((("embed", "head"), (d, V), dt, d ** -0.5))
    norm = model["norm"] != "nonparam_ln"
    if model["norm"] not in ("rmsnorm", "nonparam_ln"):
        raise NotImplementedError(f"norm {model['norm']}")
    for gi, g in enumerate(model["groups"]):
        n = g["count"]
        for ki, kind in enumerate(g["pattern"]):
            if kind not in ("attn", "local"):
                raise NotImplementedError(f"layer kind {kind}")
            at = ("groups", gi, ki)
            if norm:
                leaves += [(at + ("ln1", "scale"), (n, d), dt, None),
                           (at + ("ln2", "scale"), (n, d), dt, None)]
            leaves += [(at + ("attn", "wq"), (n, d, H, dh), dt, d ** -0.5),
                       (at + ("attn", "wk"), (n, d, G, dh), dt, d ** -0.5),
                       (at + ("attn", "wv"), (n, d, G, dh), dt, d ** -0.5),
                       (at + ("attn", "wo"), (n, H, dh, d), dt, (H * dh) ** -0.5)]
            E = model.get("n_experts", 0)
            cols = 2 * ff if gated else ff
            if E:
                leaves += [(at + ("moe", "router"), (n, d, E), torch.float32, d ** -0.5),
                           (at + ("moe", "w_in"), (n, E, d, 2 * ff), dt, d ** -0.5),
                           (at + ("moe", "w_out"), (n, E, ff, d), dt, ff ** -0.5)]
            else:
                leaves += [(at + ("mlp", "w_in"), (n, d, cols), dt, d ** -0.5),
                           (at + ("mlp", "w_out"), (n, ff, d), dt, ff ** -0.5)]
    if norm:
        leaves.append((("final_norm", "scale"), (d,), dt, None))
    return leaves


def nbytes(model: dict) -> int:
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for _, shape, dt, _ in layout(model))


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


def draw(model: dict, seed: int, device) -> dict:
    """The weights of ``model`` from ``seed`` on ``device``."""
    device = torch.device(device)
    leaves = layout(model)
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
    if model["norm"] == "nonparam_ln":
        for gi, g in enumerate(model["groups"]):
            for ki, _ in enumerate(g["pattern"]):
                _put(tree, ("groups", gi, ki, "ln1"), None)
                _put(tree, ("groups", gi, ki, "ln2"), None)
        tree["final_norm"] = None
    return _as_tuples(tree)

"""The code of a decoder-only model, for every configuration that names no
other module (``"reference"`` in a configuration file's ``model`` section;
``decoder`` where absent): the layout the benchmark draws its weights in
(``layout``, ``absent``), the plain float32 reference that decides
``correct`` (``logits``) and the counts module its readers use (``WORK``:
``perfbench/work/serve.py``).  A configuration that this module does not
cover brings ``perfbench/reference/<name>.py`` with the same four names,
and ``perfbench/work/<name>.py`` where ``serve.py`` does not count it.

The reference is the full forward pass over whole sequences, no cache, no
kernels, no batching tricks.  It follows the configuration's ``model``
section: token embedding; layers of pre-norm (RMSNorm with its scale, or
LayerNorm without one) causal self-attention with grouped KV heads,
split-half RoPE and an optional sliding window, then a SwiGLU MLP or a
top-k mixture of experts (softmax router in float32, the top-k gates
renormalised, each expert a SwiGLU MLP); a final norm and the head (the
embedding table, transposed, when tied).

The weights are the benchmark's own tensors, in the layout it draws them
(``layout``, ``perfbench.weights``): one tree with ``embed``, ``groups``
(leaves stacked over each group's count) and ``final_norm``.  Each leaf is
read in its stored dtype and cast to float32 where it is used, one layer or
one expert at a time, so that the reference fits beside a model that fills
most of the card.  Matrix products run in float32 with TF32 off.

``linear`` computes every product of activations with a weight matrix; the
control passes one that rounds both to a lower precision first
(``precision.fp8_linear``).  The router's product, the attention scores and
the softmaxes stay in float32 in every case.

Departures from the published models, both of which the program shares:
the RMSNorm's eps is 1e-6 for every model, the LayerNorm's 1e-5; the
vocabulary is padded to a multiple of 256 rows.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from .precision import f32_linear

WORK = "serve"  # perfbench/work/serve.py counts this module's models
RMS_EPS = 1e-6
LN_EPS = 1e-5
QUERY_CHUNK = 1024  # queries a block in attention: bounds the score matrix
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KINDS = ("attn", "local")
NORMS = ("rmsnorm", "nonparam_ln")


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def vocab_rows(model: dict) -> int:
    """The vocabulary padded to a multiple of 256 rows, the port's padding."""
    return -(-model["vocab_size"] // 256) * 256


def _kinds(model: dict):
    """(group index, kind index, count, kind) of every layer kind."""
    if model["norm"] not in NORMS:
        raise NotImplementedError(f"norm {model['norm']}")
    for gi, g in enumerate(model["groups"]):
        for ki, kind in enumerate(g["pattern"]):
            if kind not in KINDS:
                raise NotImplementedError(f"layer kind {kind}")
            yield gi, ki, g["count"], kind


def layout(model: dict) -> List[Tuple]:
    """Every leaf of the port's parameter tree for this model: (path,
    shape, dtype, std), std None for a norm's ones.  Matrices are normal
    with std 1/sqrt(fan-in), the port's own init; the router is float32."""
    dt = DTYPES[model.get("dtype", "bfloat16")]
    d, H, G, dh = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    ff, V = model["d_ff"], vocab_rows(model)
    gated = model.get("gated", True)
    leaves = [(("embed", "tok"), (V, d), dt, d ** -0.5)]
    if not model.get("tie_embeddings"):
        leaves.append((("embed", "head"), (d, V), dt, d ** -0.5))
    norm = model["norm"] != "nonparam_ln"
    for gi, ki, n, _ in _kinds(model):
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


def absent(model: dict) -> List[Tuple]:
    """The paths the port holds as None: a LayerNorm without parameters."""
    if model["norm"] != "nonparam_ln":
        return []
    return [("groups", gi, ki, ln) for gi, ki, _, _ in _kinds(model)
            for ln in ("ln1", "ln2")] + [("final_norm",)]


def _norm(model: dict, x: torch.Tensor, p: Optional[dict]) -> torch.Tensor:
    if model["norm"] == "rmsnorm":
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + RMS_EPS)
        return y * p["scale"].float()
    if model["norm"] == "nonparam_ln":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + LN_EPS)
    raise NotImplementedError(f"norm {model['norm']}")


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x (..., L, heads, dh) at positions (L,)."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = pos.float()[:, None] * freqs  # (L, dh/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """Causal attention of one sequence: q (L, H, dh), k and v (L, G, dh)."""
    L, H, dh = q.shape
    G = k.shape[1]
    qg = q.reshape(L, G, H // G, dh)
    out = torch.empty_like(qg)
    kpos = torch.arange(L, device=q.device)
    for s in range(0, L, QUERY_CHUNK):
        e = min(s + QUERY_CHUNK, L)
        scores = torch.einsum("qgmd,kgd->gmqk", qg[s:e], k) * dh ** -0.5
        qpos = kpos[s:e, None]
        ok = kpos[None, :] <= qpos
        if window:
            ok &= kpos[None, :] > qpos - window
        scores = scores.masked_fill(~ok, float("-inf"))
        out[s:e] = torch.einsum("gmqk,kgd->qgmd", torch.softmax(scores, dim=-1), v)
    return out.reshape(L, H, dh)


def _attention(model: dict, p: dict, h: torch.Tensor, window: int,
               linear: Callable) -> torch.Tensor:
    R, L, d = h.shape
    H, G, dh = model["n_heads"], model["n_kv_heads"], head_dim(model)
    pos = torch.arange(L, device=h.device)
    q = linear(h, p["wq"].reshape(d, H * dh)).view(R, L, H, dh)
    k = linear(h, p["wk"].reshape(d, G * dh)).view(R, L, G, dh)
    v = linear(h, p["wv"].reshape(d, G * dh)).view(R, L, G, dh)
    q, k = _rope(q, pos, model["rope_theta"]), _rope(k, pos, model["rope_theta"])
    o = torch.stack([_attend(q[r], k[r], v[r], window) for r in range(R)])
    return linear(o.reshape(R, L, H * dh), p["wo"].reshape(H * dh, d))


def _swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
            linear: Callable) -> torch.Tensor:
    """w_in's columns are [gate | up]."""
    gate, up = linear(x, w_in).chunk(2, dim=-1)
    return linear(torch.nn.functional.silu(gate) * up, w_out)


def _moe(model: dict, p: dict, h: torch.Tensor, linear: Callable) -> torch.Tensor:
    """Top-k routing, each token through its k experts only."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, model["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(model["n_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = _swiglu(x[rows], p["w_in"][e], p["w_out"][e], linear)
            y.index_add_(0, rows, out * gates[rows, slot, None])
    return y.reshape(shape)


def _layer(tree, i: int):
    """Repetition ``i`` of a stacked leaf tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def logits(model: dict, params: dict, tokens: torch.Tensor, first: int,
           linear: Callable = f32_linear) -> torch.Tensor:
    """Float32 logits (R, L - first, vocabulary rows) at positions
    ``first``..L-1 of the sequences ``tokens`` (R, L), each over its own
    positions 0..L-1."""
    x = params["embed"]["tok"][tokens.long()].float()
    for group, gp in zip(model["groups"], params["groups"]):
        for i in range(group["count"]):
            for kind, lp in zip(group["pattern"], gp):
                p = _layer(lp, i)
                window = model.get("window", 0) if kind == "local" else 0
                if kind not in ("attn", "local"):
                    raise NotImplementedError(f"layer kind {kind}")
                x = x + _attention(model, p["attn"], _norm(model, x, p["ln1"]), window, linear)
                h = _norm(model, x, p["ln2"])
                if model.get("n_experts", 0):
                    x = x + _moe(model, p["moe"], h, linear)
                else:
                    x = x + _swiglu(h, p["mlp"]["w_in"], p["mlp"]["w_out"], linear)
    x = _norm(model, x[:, first:], params["final_norm"])
    table = params["embed"]["tok"].T if model.get("tie_embeddings") else params["embed"]["head"]
    return linear(x, table)

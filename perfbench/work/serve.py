"""Useful FLOPs and least bytes of serving a decoder-only model, from a
configuration file's ``model`` section (its layer groups, widths, heads,
experts and dtype).

FLOPs count the model's work: 2 per multiply-add of every weight matrix a
token passes through, a mixture-of-experts layer at ``top_k`` experts (never
all ``n_experts``), causal attention over the positions a query actually
attends (within the window where there is one), the head only where logits
are taken (prefill's last position, each decode step).  Bytes count each
weight a step needs read once, the filled cache positions read once and the
new keys and values written once.  So a faster path through the same model
(a routed expert layer, attention in the cache's own dtype) raises a share
of these counts without changing them.
"""
from __future__ import annotations

ATTENTION_KINDS = ("attn", "local")
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def layer_kinds(model: dict) -> list:
    """Every layer's kind, in order."""
    return [kind for g in model["groups"] for _ in range(g["count"]) for kind in g["pattern"]]


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def vocab_rows(model: dict) -> int:
    """Rows of the embedding table and columns of the head as run: the
    vocabulary rounded up to a multiple of 256, the port's padding."""
    return -(-model["vocab_size"] // 256) * 256


def element_bytes(model: dict) -> int:
    return DTYPE_BYTES[model.get("dtype", "bfloat16")]


def _window(model: dict, kind: str) -> int:
    return model.get("window", 0) if kind == "local" else 0


def _check_kinds(model: dict) -> None:
    bad = set(layer_kinds(model)) - set(ATTENTION_KINDS)
    if bad:
        raise NotImplementedError(f"work counts cover attention decoders; layer kinds {bad}")


def attention_matrix_params(model: dict) -> int:
    d, H, G, dh = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    return d * H * dh + 2 * d * G * dh + H * dh * d


def ffn_matrix_params(model: dict, experts: int) -> int:
    """The feed-forward matrices a layer reads for ``experts`` experts (the
    dense MLP when the model has none)."""
    d, ff = model["d_model"], model["d_ff"]
    per = (3 if model.get("gated", True) else 2) * d * ff
    return per * (experts if model.get("n_experts", 0) else 1)


def router_params(model: dict) -> int:
    return model["d_model"] * model.get("n_experts", 0)


def token_matrix_params(model: dict) -> int:
    """Weights one token multiplies through in all layers (the head apart):
    attention projections, the router and ``top_k`` experts, or the MLP."""
    _check_kinds(model)
    per_layer = (attention_matrix_params(model) + router_params(model)
                 + ffn_matrix_params(model, model.get("top_k", 0)))
    return per_layer * len(layer_kinds(model))


def head_params(model: dict) -> int:
    return model["d_model"] * vocab_rows(model)


def attended_pairs(seq_len: int, window: int = 0) -> int:
    """(query, key) pairs of causal attention over ``seq_len`` positions,
    each query seeing itself and the ``window - 1`` before it (0: all)."""
    if not window or window >= seq_len:
        return seq_len * (seq_len + 1) // 2
    return window * (window + 1) // 2 + (seq_len - window) * window


def _attention_pair_flops(model: dict) -> int:
    """QK^T and PV: 2 multiply-adds of ``head_dim`` per pair and query head."""
    return 4 * head_dim(model) * model["n_heads"]


def prefill_flops(model: dict, batch: int, seq_len: int) -> float:
    """Prefill of ``batch`` prompts of ``seq_len``, logits at the last
    position only."""
    dense = 2 * token_matrix_params(model) * batch * seq_len
    attn = sum(_attention_pair_flops(model) * batch * attended_pairs(seq_len, _window(model, k))
               for k in layer_kinds(model))
    return float(dense + attn + 2 * head_params(model) * batch)


def decode_step_flops(model: dict, batch: int, pos: int) -> float:
    """One decode step of ``batch`` tokens at position ``pos`` (0-based):
    each attends the ``pos + 1`` filled positions (within its window)."""
    dense = 2 * token_matrix_params(model) * batch
    attn = 0
    for k in layer_kinds(model):
        w = _window(model, k)
        keys = min(pos + 1, w) if w else pos + 1
        attn += _attention_pair_flops(model) * batch * keys
    return float(dense + attn + 2 * head_params(model) * batch)


def batch_flops(model: dict, batch: int, prompt_len: int, new_tokens: int) -> float:
    """A served batch: prefill, whose last position gives the first new
    token, then the ``new_tokens - 1`` decode steps that give the others."""
    return prefill_flops(model, batch, prompt_len) + sum(
        decode_step_flops(model, batch, prompt_len + i) for i in range(new_tokens - 1))


def decode_weight_bytes(model: dict, batch: int) -> float:
    """Weights a decode step of ``batch`` tokens reads once: every layer's
    attention projections, norms, router and the experts its tokens can
    reach (``min(n_experts, batch * top_k)``, where routes spread), the
    head (the embedding table when tied) and the final norm.  The embedding
    rows gathered for the tokens are counted apart from a tied table."""
    _check_kinds(model)
    el = element_bytes(model)
    d = model["d_model"]
    n_exp = model.get("n_experts", 0)
    reached = min(n_exp, batch * model.get("top_k", 0)) if n_exp else 0
    norms = 0 if model.get("norm") == "nonparam_ln" else 2 * d
    per_layer = (el * (attention_matrix_params(model) + ffn_matrix_params(model, reached) + norms)
                 + 4 * router_params(model))  # the router is f32
    head = el * head_params(model)
    rows = 0 if model.get("tie_embeddings") else el * batch * d
    final = 0 if model.get("norm") == "nonparam_ln" else el * d
    return float(per_layer * len(layer_kinds(model)) + head + rows + final)


def kv_bytes_per_position(model: dict, batch: int) -> int:
    """K and V of one position in one layer, over the batch."""
    return 2 * batch * model["n_kv_heads"] * head_dim(model) * element_bytes(model)


def decode_step_least_bytes(model: dict, batch: int, pos: int) -> float:
    """Least bytes of a decode step at position ``pos``: the weights once,
    K and V of the ``pos + 1`` filled positions (within the window) read
    once, the new K and V written once."""
    kv = 0
    per_pos = kv_bytes_per_position(model, batch)
    for k in layer_kinds(model):
        w = _window(model, k)
        filled = min(pos + 1, w) if w else pos + 1
        kv += per_pos * (filled + 1)
    return decode_weight_bytes(model, batch) + kv


def flash_launch_flops(model: dict, batch: int, seq_len: int, window: int = 0) -> float:
    """One prefill attention call (one layer) of the flash kernel."""
    return float(_attention_pair_flops(model) * batch * attended_pairs(seq_len, window))


def flash_launch_bytes(model: dict, batch: int, seq_len: int) -> float:
    """Q, K and V read once and O written once."""
    H, G = model["n_heads"], model["n_kv_heads"]
    return float(element_bytes(model) * batch * seq_len * head_dim(model) * (2 * H + 2 * G))


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    bf16 tensor-core peak and the bytes at the HBM peak."""
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])

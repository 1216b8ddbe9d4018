"""Serving entry points: cache init, prefill and single-token decode.

Ported from ``repro.models.decode`` for every layer kind, ATTN and LOCAL
layers with their MoE layer where the config has experts (its aux loss is
dropped, as the reference drops it).  Caches
mirror the parameter structure: one tuple per layer group, one dict per
layer kind of the group's pattern, leaves stacked over the group's
``count``: a KV cache for ATTN; a ring-buffer KV cache of capacity
``min(window, capacity)`` for LOCAL (O(1) in context length); the cross K/V
over the frontend (``ck``, ``cv``) for XATTN; a KV cache (``kv``) and the
cross K/V for ATTNX; the O(1) recurrent state and the two token shifts for
RWKV; the recurrence state and the conv tail for RGLRU.  A Python loop over
the stack replaces ``lax.scan``.  Decode writes each new key and value, or
the new states and shifts, into the stacked cache in place (through
per-layer views) and hands back the same cache object; the JAX package
returns a new one.  Its ``pos`` is a device tensor, so that ``DecodeGraph``
can capture a whole step as one CUDA graph, the counterpart of the JAX
package's jitted decode step.

``prefill`` and ``decode_step`` take a ``DistContext`` (``dist``): each rank
then works on its slot of the batch, and the MoE layer runs over the
expert axes.  Given the rank's blocks over the model axis (the dry-run's
serving steps), self-attention runs on its heads against its block of the
KV caches, the MLP on its FF block, and the logits are its vocabulary
block (``models.transformer``); given whole weights (serve's world) they
compute whole.  A world's collectives run on the host (gloo) or outside any
captured graph, so a step of a world is run eagerly; ``DecodeGraph`` is
for ``dist=None``.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ATTN, ATTNX, LOCAL, RGLRU, RWKV, XATTN, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import griffin, rwkv
from repro_torch.models.common import apply_norm, dtype_of, mlp_apply, unembed
from repro_torch.models.convert import tree_map
from repro_torch.models.transformer import (
    DistContext,
    _embed_tokens,
    _positions_embed,
    check_supported,
    feed_forward,
    frontend_states,
    gate,
    layer_params,
    post_norm,
)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int, device) -> dict:
    if kind == ATTN:
        return attn.init_kv_cache(cfg, batch, capacity, device=device)
    if kind == LOCAL:
        return attn.init_kv_cache(cfg, batch, attn.cache_capacity(cfg.window, capacity),
                                  device=device)
    if kind in (XATTN, ATTNX):
        shape = (batch, max(cfg.frontend_tokens, 1), cfg.n_kv_heads, cfg.head_dim_)
        cache = {"ck": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                 "cv": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
        if kind == ATTNX:
            cache["kv"] = attn.init_kv_cache(cfg, batch, capacity, device=device)
        return cache
    if kind == RWKV:
        return rwkv.init_rwkv_cache(cfg, batch, device=device)
    if kind == RGLRU:
        return griffin.init_rglru_cache(cfg, batch, device=device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, device=None) -> tuple:
    """Empty caches for every group, stacked over the group's count."""
    check_supported(cfg)
    groups = []
    for g in cfg.groups:
        single = [_layer_cache(cfg, kind, batch, capacity, device) for kind in g.pattern]
        # a broadcast copy, not repeat: on the meta device repeat (and clone)
        # import sympy, about a second that a shed would pay mid-request
        groups.append(tree_map(lambda t: t.new_empty((g.count, *t.shape)).copy_(t),
                               tuple(single)))
    return tuple(groups)


def _stack_dicts(dicts: list) -> dict:
    """Dicts of one structure (nested, as ATTNX's ``kv``) -> one dict whose
    leaves are stacked over the list."""
    return {key: _stack_dicts([d[key] for d in dicts]) if isinstance(dicts[0][key], dict)
            else torch.stack([d[key] for d in dicts]) for key in dicts[0]}


def _stack(per_rep: list) -> tuple:
    """[rep][kind] -> (kind) of dicts with leaves stacked over rep."""
    return tuple(_stack_dicts([rep[j] for rep in per_rep]) for j in range(len(per_rep[0])))


def _prefill_attention(cfg: ModelConfig, p: dict, h: torch.Tensor, positions: torch.Tensor,
                       capacity: int, window: int, dist: Optional[DistContext]
                       ) -> Tuple[torch.Tensor, dict]:
    """Prefill's self-attention on all heads or this rank's
    (``attention.tp_heads``): (its output, the KV cache of ``wk``'s heads)."""
    p, h, split, sel = attn.tp_heads(cfg, p, h, dist)
    q, k, v = attn.qkv_proj(cfg, p, h, positions)
    cache = attn.cache_from_kv(k, v, positions, capacity)
    o = attn.attend(cfg, q, attn.kv_heads(k, sel), attn.kv_heads(v, sel), positions, positions,
                    window=window)
    return attn.attn_out(p, o, split, dist), cache


def _prefill_layer(
    cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, positions: torch.Tensor,
    enc: Optional[torch.Tensor], capacity: int, dist: Optional[DistContext] = None,
) -> Tuple[torch.Tensor, dict]:
    if kind in (ATTN, LOCAL):
        window = cfg.window if kind == LOCAL else 0
        h = apply_norm(cfg, x, p["ln1"])
        cap = capacity if kind == ATTN else attn.cache_capacity(cfg.window, capacity)
        a, cache = _prefill_attention(cfg, p["attn"], h, positions, cap, window, dist)
        x = x + post_norm(cfg, p, "post_ln1", a)
        h = apply_norm(cfg, x, p["ln2"])
        m = feed_forward(cfg, p, h, dist, with_aux=False)[0]
        return x + post_norm(cfg, p, "post_ln2", m), cache
    if kind == XATTN:
        ck, cv = attn.cross_kv(cfg, p["xattn"], enc)
        h = apply_norm(cfg, x, p["ln1"])
        x = x + gate(p, "gate_attn", x) * attn.cross_attention(cfg, p["xattn"], h, (ck, cv))
        h = apply_norm(cfg, x, p["ln2"])
        x = x + gate(p, "gate_mlp", x) * mlp_apply(cfg, p["mlp"], h, dist)
        return x, {"ck": ck, "cv": cv}
    if kind == ATTNX:
        h = apply_norm(cfg, x, p["ln1"])
        a, kv = _prefill_attention(cfg, p["attn"], h, positions, capacity, 0, dist)
        x = x + a
        ck, cv = attn.cross_kv(cfg, p["xattn"], enc)
        h = apply_norm(cfg, x, p["ln_x"])
        x = x + attn.cross_attention(cfg, p["xattn"], h, (ck, cv))
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h, dist), {"kv": kv, "ck": ck, "cv": cv}
    if kind == RWKV:
        h = apply_norm(cfg, x, p["ln1"])
        y, state = rwkv.rwkv_time_mix_prefill(cfg, p["tm_cm"], h)
        x = x + y
        h2 = apply_norm(cfg, x, p["ln2"])
        x = x + rwkv.rwkv_channel_mix(cfg, p["tm_cm"], h2)
        # the shifts are the last position's normed inputs, not x
        return x, {"state": state, "tm_shift": h[:, -1], "cm_shift": h2[:, -1]}
    if kind == RGLRU:
        h = apply_norm(cfg, x, p["ln1"])
        y, cache = griffin.rglru_block_prefill(cfg, p["rec"], h)
        x = x + y
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h, dist), cache
    raise ValueError(kind)


def prefill(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S)
    *,
    frontend: Optional[torch.Tensor] = None,  # (B, T, frontend_dim) stub embeddings
    capacity: Optional[int] = None,
    dist: Optional[DistContext] = None,
) -> Tuple[torch.Tensor, tuple]:
    """Returns (logits of the last position (B, V) f32, caches); with
    ``dist``, of this rank's slot of the batch (and of its vocabulary block
    and KV heads where the parameters are its blocks over the model axis)."""
    check_supported(cfg)
    S = tokens.shape[1]
    capacity = capacity or S
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    enc = frontend_states(cfg, params, frontend, dist)
    x = _embed_tokens(cfg, params, tokens, dist)
    x = _positions_embed(cfg, params, x, positions)

    caches = []
    for group, gp in zip(cfg.groups, params["groups"]):
        per_rep = []
        for i in range(group.count):
            outs = []
            for kind, p in zip(group.pattern, layer_params(gp, i)):
                x, c = _prefill_layer(cfg, kind, p, x, positions, enc, capacity, dist)
                outs.append(c)
            per_rep.append(outs)
        caches.append(_stack(per_rep))

    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x[:, -1], dist), tuple(caches)


def _decode_layer(
    cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, pos: torch.Tensor, cache: dict,
    dist: Optional[DistContext] = None,
) -> torch.Tensor:
    if kind in (ATTN, LOCAL):
        h = apply_norm(cfg, x, p["ln1"])
        a, _ = attn.decode_attention(cfg, p["attn"], h, pos, cache,
                                     window=cfg.window if kind == LOCAL else 0, dist=dist)
        x = x + post_norm(cfg, p, "post_ln1", a)
        h = apply_norm(cfg, x, p["ln2"])
        m = feed_forward(cfg, p, h, dist, with_aux=False)[0]
        return x + post_norm(cfg, p, "post_ln2", m)
    if kind == XATTN:
        h = apply_norm(cfg, x, p["ln1"])
        a = attn.cross_attention(cfg, p["xattn"], h, (cache["ck"], cache["cv"]))
        x = x + gate(p, "gate_attn", x) * a
        h = apply_norm(cfg, x, p["ln2"])
        return x + gate(p, "gate_mlp", x) * mlp_apply(cfg, p["mlp"], h, dist)
    if kind == ATTNX:
        h = apply_norm(cfg, x, p["ln1"])
        a, _ = attn.decode_attention(cfg, p["attn"], h, pos, cache["kv"], dist=dist)
        x = x + a
        h = apply_norm(cfg, x, p["ln_x"])
        x = x + attn.cross_attention(cfg, p["xattn"], h, (cache["ck"], cache["cv"]))
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h, dist)
    if kind == RWKV:
        h = apply_norm(cfg, x, p["ln1"])
        y, _ = rwkv.rwkv_time_mix_decode(cfg, p["tm_cm"], h, cache)
        x = x + y
        h2 = apply_norm(cfg, x, p["ln2"])
        y2, _ = rwkv.rwkv_channel_mix_decode(cfg, p["tm_cm"], h2, cache)
        return x + y2
    if kind == RGLRU:
        h = apply_norm(cfg, x, p["ln1"])
        y, _ = griffin.rglru_block_decode(cfg, p["rec"], h, cache)
        x = x + y
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h, dist)
    raise ValueError(kind)


def decode_step(
    cfg: ModelConfig,
    params: dict,
    caches: tuple,
    token: torch.Tensor,  # (B, 1)
    pos: Union[int, torch.Tensor],  # absolute position of this token
    dist: Optional[DistContext] = None,
) -> Tuple[torch.Tensor, tuple]:
    """Returns (logits (B, V) f32, caches) with ``caches`` updated in place;
    with ``dist``, ``token`` and the caches are this rank's slot.

    ``pos`` is a 0-d int32 tensor on the token's device, as the JAX package
    traces it, or an int, which becomes such a tensor here.  Given a tensor,
    the step reads no device value on the host, so it can be captured in a
    CUDA graph and replayed (``DecodeGraph``)."""
    pos = attn.as_pos(pos, token.device)
    x = _embed_tokens(cfg, params, token, dist)
    x = _positions_embed(cfg, params, x, pos.view(1))
    for group, gp, gc in zip(cfg.groups, params["groups"], caches):
        for i in range(group.count):
            for kind, p, c in zip(group.pattern, layer_params(gp, i), layer_params(gc, i)):
                x = _decode_layer(cfg, kind, p, x, pos, c, dist)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x[:, -1], dist), caches


def _cut(live, target):
    if isinstance(live, dict):
        return {k: _cut(v, target[k]) for k, v in live.items()}
    if isinstance(live, (tuple, list)):
        return type(live)(_cut(v, t) for v, t in zip(live, target))
    out = live
    for ax in range(out.dim()):
        if out.shape[ax] != target.shape[ax]:
            out = out.narrow(ax, 0, target.shape[ax])
    return out.clone(memory_format=torch.contiguous_format)


def cut_caches(cfg: ModelConfig, caches: tuple, batch: int, capacity: int) -> tuple:
    """Prefill's (or decode's) caches cut to their first ``batch`` rows: the
    counterpart of the JAX serve loop's shed, which slices each leaf to the
    shape ``jax.eval_shape`` of prefill gives at the smaller batch.  The
    target shapes come from ``init_caches`` on the meta device.  The batch
    axis is not always first (leaves are stacked over each group's count),
    so every axis whose size differs is cut.  Every leaf of the result is a
    new contiguous tensor: a captured graph holds its inputs' addresses."""
    return _cut(caches, init_caches(cfg, batch, capacity, device="meta"))


class DecodeGraph:
    """Greedy decode of one batch, each step after the first one replay of a
    captured CUDA graph: the counterpart of the JAX package's jitted,
    cache-donating ``decode_step``.

    A step (``decode_step``, the greedy ``argmax`` and the bookkeeping around
    them) reads and writes only static buffers: the token (B, 1), ``pos`` (a
    0-d int32 tensor), the caches (prefill's, written in place) and the
    generations (B, n_steps), where the step stores the token it is fed.  The
    step ends by writing its pick into the token buffer and adding 1 to
    ``pos``, so the host has nothing to do between two steps.

    On a CUDA device the first ``step()`` runs the step eagerly on a side
    stream, as the capture's warm-up (a real step: it writes the caches and
    advances ``pos``), then captures it into one ``torch.cuda.CUDAGraph``;
    every later ``step()`` is one ``replay()``.  A capture that fails raises;
    nothing runs eagerly instead.  On the CPU every step runs eagerly.

    ``shed(caches)`` drops the last live sequence between two steps and goes
    on with the remaining steps at the smaller batch: on the card the old
    graph is released and the next ``step()`` warms up and captures again
    (``recapture_seconds``).  The shed row of ``tokens`` keeps the token it
    was fed for the next step and reads -1 after it, the JAX serve loop's
    padding.
    """

    def __init__(self, cfg: ModelConfig, params: dict, caches: tuple, token: torch.Tensor,
                 pos: Union[int, torch.Tensor], n_steps: int):
        self.cfg, self.params, self.caches = cfg, params, caches
        self.n_steps, self.steps = n_steps, 0
        self.token = token.clone()
        # the step advances its own copy of pos, never the caller's tensor
        self.pos = attn.as_pos(pos, token.device).clone()
        self.start = self.pos.clone()
        self.tokens = torch.zeros((token.shape[0], n_steps), dtype=token.dtype,
                                  device=token.device)
        self.live = self.tokens  # the rows still decoding
        self.graph = self.static_logits = None
        self.first_step_seconds = self.capture_seconds = 0.0
        self.recapture_seconds: list = []

    @property
    def batch(self) -> int:
        return self.token.shape[0]

    def shed(self, caches: tuple) -> None:
        """Drop the last live sequence before the next step: ``caches`` are
        the live caches cut to ``batch - 1`` rows (``cut_caches``).  The
        shed row records the token it was to be fed at this step and -1 for
        every later step.  On the card this synchronises the device and
        releases the captured graph (two graphs' pools and two sets of
        caches would otherwise stay alive); the next ``step()`` captures the
        step again at the smaller batch."""
        b, i = self.batch, self.steps
        if i == self.n_steps:
            raise RuntimeError(f"DecodeGraph.shed: all {self.n_steps} steps have run")
        if b < 2:
            raise ValueError("DecodeGraph.shed: the batch is already 1")
        self.tokens[b - 1, i] = self.token[b - 1, 0]
        self.tokens[b - 1, i + 1:] = -1
        if self.graph is not None:
            torch.cuda.synchronize(self.token.device)
            self.graph.reset()
            self.graph = self.static_logits = None
        self.caches = caches
        self.token = self.token[: b - 1].clone()
        self.live = self.tokens[: b - 1]

    def _step(self) -> torch.Tensor:
        self.live.index_copy_(1, (self.pos - self.start).view(1).long(), self.token)
        logits, _ = decode_step(self.cfg, self.params, self.caches, self.token, self.pos)
        self.token.copy_(logits.argmax(dim=-1, keepdim=True))
        self.pos.add_(1)
        return logits

    def step(self) -> torch.Tensor:
        """Runs the next step and returns its logits (B, V) f32.  After the
        first step on the card these are the graph's static output, which
        the next replay overwrites."""
        if self.steps == self.n_steps:
            raise RuntimeError(f"DecodeGraph: all {self.n_steps} steps have run")
        self.steps += 1
        if self.token.device.type != "cuda":
            return self._step()
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        return self.static_logits

    def _warm_up_and_capture(self) -> torch.Tensor:
        t0 = time.perf_counter()
        device = self.token.device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self._step()  # step 0: the warm-up is a real step
        main.wait_stream(side)
        logits.record_stream(main)
        if self.steps < self.n_steps:
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):  # records the step; runs nothing
                static_logits = self._step()
            seconds = time.perf_counter() - t1
            if self.steps == 1:
                self.capture_seconds = seconds
            else:
                self.recapture_seconds.append(seconds)
            self.graph, self.static_logits = graph, static_logits
        if self.steps == 1:
            self.first_step_seconds = time.perf_counter() - t0
        return logits

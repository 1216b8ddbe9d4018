"""Mixture-of-Experts layer: top-k routing, the dense path, and the
expert-parallel path on the all-to-all.

Ported from ``repro.models.moe``.  This is the paper's MPI_Alltoall(v)
case study inside the model: the expert-parallel dispatch is a real
all-to-all whose strategy (direct / chunked / hierarchical) the caller
picks.

Expert-shard ("virtual expert") layout, the reference's: the expert axes
carry P = E·r devices, r = ``ep_shards``; each expert's FF width is split
into r shards, and virtual expert j on device j implements (expert j // r,
ff-shard j % r).  A token routed to expert e is sent to all r of its
shards, each returns a partial output, and the source sums the r partials.
Weights are stored in that layout from init: ``w_in`` (E·r, d, 2·ff/r),
``w_out`` (E·r, ff/r, d).  ``moe_params(..., expert_block=(start, n))``
keeps only virtual experts start..start+n of each layer while drawing
every matrix in the single-device order (one matrix at a time), so a rank
holds exactly its rows of the weights a single-device init draws.  The
router is f32 whatever the model dtype.

``moe_apply_dense`` runs every token through every virtual expert, as the
reference's single-device path does, and weights the outputs by the top-k
gates: E / top_k times the products a routed path needs, and no token is
dropped.  Every step stays on the device (no host read of a routing
decision), so a decode step that holds the layer can be captured in a CUDA
graph.

``moe_apply_sharded_inner`` is the reference's body under ``shard_map``, as
one rank's program in a ``torch.distributed`` world: capacity buckets of C
tokens per (source, expert), C = ``capacity`` of the rank's token slice;
overflow tokens are dropped, as in the reference.  Its collectives go
through ``repro_torch.comms`` (and so ``comms.routes``); it serves one
virtual expert a device and refuses any other layout
(``check_ep_layout``).  Gradients flow through it as the reference's
``shard_map`` transposes them when the expert axes are apart from the data
axes (every rank of an expert group computes the same loss): the
all-to-all's backward is the all-to-all, the all-gather of slices takes
back the rank's slice, and the token slice's input and the replicated
router have their gradients summed over the expert axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, dtype_of
from repro_torch.obs import trace


def _stacked_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
                  fan_in: int, block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``dense_init`` of ``shape`` (..., E·r, rows, cols) drawn one trailing
    matrix at a time into a tensor of ``dtype``: the f32 draw of a whole
    stack at once (51.5 GB for mixtral-8x22b's ``w_in`` over 8 layers) would
    not fit beside the weights on one card.  With ``block`` (start, n) every
    matrix is still drawn, in the same order, but only virtual experts
    start..start+n of each stack are kept: (..., n, rows, cols)."""
    start, n = (0, shape[-3]) if block is None else block
    out = torch.empty(shape[:-3] + (n,) + shape[-2:], dtype=dtype, device=gen.device)
    if out.is_meta:  # shapes only (META_GEN): nothing to draw
        return out
    kept = out.view(-1, n, *shape[-2:])
    for i in range(kept.shape[0]):
        for e in range(shape[-3]):
            w = dense_init(gen, shape[-2:], dtype, fan_in=fan_in)
            if start <= e < start + n:
                kept[i, e - start].copy_(w)
    return out


def moe_params(cfg: ModelConfig, gen: torch.Generator, lead: Tuple[int, ...] = (),
               ep_shards: int = 1, expert_block: Optional[Tuple[int, int]] = None) -> dict:
    """The JAX package's keys, shapes, dtypes and std, in the virtual layout
    of ``ep_shards``; ``lead`` prepends stacking axes (a layer group's
    count); ``expert_block`` (start, n) keeps only those virtual experts."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    r = ep_shards
    if ff % r:
        raise ValueError(f"{cfg.name}: d_ff {ff} does not split into {r} expert shards")
    ffv = ff // r
    dt = dtype_of(cfg)
    return {
        "router": dense_init(gen, lead + (d, E), torch.float32, fan_in=d),
        "w_in": _stacked_init(gen, lead + (E * r, d, 2 * ffv), dt, fan_in=d,
                              block=expert_block),
        "w_out": _stacked_init(gen, lead + (E * r, ffv, d), dt, fan_in=ffv,
                               block=expert_block),
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


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


# --------------------------------------------------------------------------
# Sharded path: one rank's program; the expert axes carry the experts.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEAxis:
    name: object  # mesh axis (or tuple of axes) carrying virtual experts
    size: int  # P = E * r = prod(axis_sizes)
    ep_shards: int  # r
    axis_sizes: Tuple[int, ...] = ()  # per-axis sizes (multi-axis EP)

    @property
    def names(self):
        return self.name if isinstance(self.name, tuple) else (self.name,)


def check_ep_layout(cfg: ModelConfig, ep_size: int, ep_shards: int) -> None:
    """Refuse expert axes that do not hold exactly one virtual expert a
    device.  The reference's ``tp_adapt`` gives ``ep_shards`` 1 whenever the
    expert count is a multiple of the model axis (or the axis is 1), and its
    sharded layer then fails reshaping the returned buckets; the port says
    why before any collective."""
    want = cfg.n_experts * ep_shards
    if ep_size != want:
        raise ValueError(
            f"{cfg.name}: expert axes of {ep_size} devices for {cfg.n_experts} experts in "
            f"{ep_shards} shard(s) each; the expert-parallel layer serves one virtual "
            f"expert a device, so the expert axes must hold E x ep_shards = {want} devices "
            "(tp_adapt gives ep_shards 1 whenever the expert count is a multiple of the "
            "model axis, or the axis is 1)")


class _AllToAll(torch.autograd.Function):
    """An all-to-all along dim 0 (``exchange``); its backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, buf, exchange):
        ctx.exchange = exchange
        return exchange(buf.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.exchange(g.contiguous()), None


class _GatherSlices(torch.autograd.Function):
    """All-gather of the ranks' slices along dim 0 into a result every rank
    of the group then uses alike; the backward takes back this rank's
    slice."""

    @staticmethod
    def forward(ctx, part, group, index):
        from repro_torch.comms import routes

        part = part.contiguous()
        out = part.new_empty((dist.get_world_size(group) * part.shape[0],) + part.shape[1:])
        routes.all_gather(out, part, group)
        ctx.index, ctx.n = index, part.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.n, ctx.n), None, None


class _SumGrad(torch.autograd.Function):
    """The identity on a tensor every rank of the group holds alike but uses
    only in part; the backward sums the parts' gradients over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.comms import routes

        g = g.contiguous().clone()
        routes.all_reduce(g, ctx.group)
        return g, None


class _Mean(torch.autograd.Function):
    """The mean over the group of a scalar; the backward scales the gradient
    by ``back``: 1 / the group's size where every rank computes the same
    loss from the mean (the expert axes), 1 where the ranks' losses are
    averaged afterwards (the data axes)."""

    @staticmethod
    def forward(ctx, t, group, back):
        from repro_torch.comms import routes

        out = t.detach().reshape(1).clone()
        routes.all_reduce(out, group)
        ctx.back = back
        return (out / dist.get_world_size(group)).reshape(t.shape)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.back, None, None


def mean_over(t: torch.Tensor, group, back: float) -> torch.Tensor:
    return _Mean.apply(t, group, back)


def _timed(name: str, fn: Callable[[torch.Tensor], torch.Tensor],
           buf: torch.Tensor, **args) -> torch.Tensor:
    """``fn(buf)`` under a trace span; with a tracer on, the card is
    synchronised at both ends, so the span holds the collective alone."""
    if not trace.is_active():
        return fn(buf)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    with trace.span(name, bytes=buf.numel() * buf.element_size(), **args):
        out = fn(buf)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


def moe_apply_sharded_inner(
    cfg: ModelConfig,
    p: dict,  # w_in/w_out: this rank's virtual expert (1, ...); router whole
    x_loc: torch.Tensor,  # (B_loc, S, d): alike on every rank of the expert axes
    ax: MoEAxis,
    mesh,
    strategy: str = "direct",
    a2a_chunks: int = 1,
    with_aux: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Token-sliced MoE with all-to-all dispatch: one rank's program over
    ``mesh``'s expert axes ``ax``.  Returns (y_loc, aux_loss), each alike on
    every rank of the expert axes.  ``with_aux=False`` (serving, which drops
    the aux loss) skips its mean over the expert axes and returns None, as
    XLA drops the reference's unused ``pmean``."""
    from repro_torch.comms.alltoall import alltoall_direct_inner, alltoall_hier_inner
    from repro_torch.launch.mesh import axes_group

    B, S, d = x_loc.shape
    P, r, E = ax.size, ax.ep_shards, cfg.n_experts
    check_ep_layout(cfg, P, r)
    if strategy not in ("direct", "chunked", "hierarchical"):
        raise ValueError(f"moe strategy {strategy!r}: one of direct, chunked, hierarchical")
    if p["w_in"].shape[0] != 1 or p["w_out"].shape[0] != 1:
        raise ValueError(f"moe_apply_sharded_inner takes this rank's one virtual expert, got "
                         f"w_in {tuple(p['w_in'].shape)}")
    group = axes_group(mesh, ax.names)
    T = B * S
    dev = x_loc.device

    # --- my token slice -----------------------------------------------------
    xt = _SumGrad.apply(x_loc.reshape(T, d), group)
    tslice = -(-T // P)
    pad = P * tslice - T
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, d))], dim=0)
    m = dist.get_rank(group)  # linearized over the expert axes
    xs = xt[m * tslice:(m + 1) * tslice]  # (Ts, d)

    gates, idx, aux = _route(cfg, _SumGrad.apply(p["router"], group), xs)
    C = capacity(cfg, tslice)

    # --- bucket build: (E, C, d), positions in token order -------------------
    e_flat = idx.reshape(-1)  # (Ts*k,)
    t_flat = torch.arange(tslice, device=dev).repeat_interleave(cfg.top_k)
    onehot = F.one_hot(e_flat, E).to(torch.int32)  # (Ts*k, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot  # position within expert
    pos_flat = pos_all.gather(1, e_flat[:, None])[:, 0].long()
    keep = pos_flat < C
    pos_clip = pos_flat.clamp(max=C - 1)
    vals = xs[t_flat] * keep[:, None].to(xs.dtype)
    buckets = xs.new_zeros((E, C, d)).index_put((e_flat, pos_clip), vals, accumulate=True)

    # --- duplicate to virtual experts & all-to-all ---------------------------
    dest_expert = torch.arange(P, device=dev) // r
    send = buckets.index_select(0, dest_expert)  # (P, C, d)

    def one_a2a(buf):
        if strategy == "hierarchical" and len(ax.names) == 2:
            # two-hop a2a (paper §VI): over the inner (fast) axis, then the
            # outer: the slow tier sees k_outer-1 messages a rank, not P-1
            outer, inner = ax.names
            return alltoall_hier_inner(buf, mesh, outer, inner)
        return alltoall_direct_inner(buf, mesh, ax.names)

    def exchange(buf):
        if a2a_chunks > 1 and C % a2a_chunks == 0:
            # chunked a2a: independent exchanges along C (paper §IV's split
            # of the payload over the slow tier, in time)
            return torch.cat([one_a2a(q.contiguous()) for q in buf.chunk(a2a_chunks, dim=1)],
                             dim=1)
        return one_a2a(buf)

    def a2a(buf, which):
        return _timed("moe.alltoall", lambda b: _AllToAll.apply(b, exchange), buf,
                      which=which, strategy=strategy)

    recv = a2a(send, "dispatch")  # (P, C, d): slot s = bucket from source s for my shard

    # --- local expert compute (my virtual expert) ----------------------------
    h = recv @ p["w_in"][0]  # (P, C, 2ffv)
    gate_h, up_h = h.chunk(2, dim=-1)
    h = activation(cfg, gate_h) * up_h
    part = h @ p["w_out"][0]  # partial over ff shards

    back = a2a(part, "combine")  # (P, C, d): slot n = my bucket processed by dest n

    # --- combine -------------------------------------------------------------
    expert_out = back.reshape(E, r, C, d).sum(dim=1)  # (E, C, d)
    picked = expert_out[e_flat, pos_clip]  # (Ts*k, d)
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None]
    # gated sum in f32, rounded once: the dense path's bf16 einsum accumulates
    # in f32 too, so a bf16 layer gives the dense layer's values (the
    # reference rounds each gated output to x's dtype before adding)
    y_slice = torch.zeros((tslice, d), dtype=torch.float32, device=dev).index_add(
        0, t_flat, picked.float() * w.float()).to(x_loc.dtype)

    # --- reassemble slices over the expert axes ------------------------------
    y_all = _timed("moe.allgather", lambda b: _GatherSlices.apply(b, group, m), y_slice)
    y = y_all[:T].reshape(B, S, d)
    return y, (mean_over(aux, group, 1.0 / P) if with_aux else None)

"""Tensor parallelism over the mesh's model axis: the operators with which a
step splits its compute as the reference's GSPMD splits it.

The reference jits its steps with ``param_shardings`` (and
``cache_shardings``), and GSPMD then splits every product over "model".
Here each rank is a process, so the split is written out, Megatron-style:

* attention: the rank's query heads and their KV heads (column-parallel
  ``wq``/``wk``/``wv``), then the row-parallel ``wo`` and one all-reduce;
* the dense MLP: the rank's FF columns of ``w_in`` (column-parallel), the
  same rows of ``w_out`` (row-parallel), one all-reduce;
* the vocabulary: the rank's rows of the embedding table (a masked lookup
  and an all-reduce), its logits of the unembedding, and the cross-entropy
  and greedy argmax over vocabulary blocks.

:func:`copy_to_model` (identity forward, all-reduce backward) puts a
replicated activation into a column-parallel product; :func:`reduce_from_model`
(all-reduce forward, identity backward) sums a row-parallel product's
partial outputs.  With them every rank of the model axis holds the same
replicated activations and the same loss, each split weight's gradient is
the rank's block of the whole one, and each replicated weight's gradient is
the whole one.  Every collective goes through ``comms.routes``, so the
dry-run's counter sees it; with a tracer on each all-reduce is a
``tp.allreduce`` span (the card synchronised at both ends).

A layer tells its weights' blocks from whole ones by their shapes against
the config (:func:`is_block`): a whole weight computes whole on every rank,
as serve's world passes them, and a shape that is neither raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.obs import trace
from repro_torch.sharding.specs import mesh_shape


def model_group(mesh, axis: str = "model") -> Tuple[Optional[object], int, int]:
    """(the process group of ``mesh``'s ``axis``, this rank's index on it, its
    size); (None, 0, 1) where the mesh has no such axis of two or more."""
    from repro_torch.launch.mesh import axes_group

    n = mesh_shape(mesh).get(axis, 1)
    if n == 1:
        return None, 0, 1
    group = axes_group(mesh, (axis,))
    return group, tdist.get_rank(group), n


def dist_group(dist) -> Tuple[Optional[object], int, int]:
    """:func:`model_group` of a ``DistContext`` (None: no group)."""
    if dist is None:
        return None, 0, 1
    return model_group(dist.mesh, dist.model_axis)


def is_block(what: str, have: int, whole: int, dist) -> bool:
    """Whether a dim of ``have`` is this rank's block of a dim of ``whole``
    split over the model axis (False: it is whole).  Raises on anything
    else: no layer falls back from a shape it was not built for."""
    if have == whole:
        return False
    n = 1 if dist is None else mesh_shape(dist.mesh).get(dist.model_axis, 1)
    if n > 1 and whole % n == 0 and have == whole // n:
        return True
    raise ValueError(f"{what}: {have} of {whole} is neither whole nor this rank's block "
                     f"over a model axis of {n}")


def _all_reduce(t: torch.Tensor, group, op=tdist.ReduceOp.SUM) -> None:
    from repro_torch.comms import routes

    if not trace.is_active():
        routes.all_reduce(t, group, op)
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    with trace.span("tp.allreduce", bytes=t.numel() * t.element_size()):
        routes.all_reduce(t, group, op)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, dist) -> torch.Tensor:
    """``x``, alike on every rank of the model axis, into a product split over
    it: the backward sums the ranks' partial gradients."""
    group = dist_group(dist)[0]
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, dist) -> torch.Tensor:
    """The sum over the model axis of the ranks' partial outputs ``x``."""
    group = dist_group(dist)[0]
    return x if group is None else _ReduceFromModel.apply(x, group)


# --------------------------------------------------------------------------
# The vocabulary over the model axis.
# --------------------------------------------------------------------------

def _local(ids: torch.Tensor, rank: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids as rows of this rank's block, clamped into it; where they lie in it)."""
    local = ids - rank * rows
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, vocab: int, dist) -> torch.Tensor:
    """Embedding rows of ``tokens`` from ``table`` (vocab, d), whole or this
    rank's rows: the rank looks up the tokens that fall in its rows, zeros
    the others, and the ranks' lookups are summed."""
    if not is_block("embed/tok rows", table.shape[0], vocab, dist):
        return table[tokens]
    group, r, _ = dist_group(dist)
    local, inside = _local(tokens, r, table.shape[0])
    x = table[local].masked_fill(~inside[..., None], 0)
    return _ReduceFromModel.apply(x, group)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, vocab: int, dist) -> torch.Tensor:
    """-log softmax(logits)[labels] in f32 at every position; ``logits``
    (..., vocab) whole or this rank's vocabulary block.  Over blocks: the
    row max, the sum of exponentials and the label's logit are each reduced
    over the model axis (the max without gradient: the loss does not depend
    on it)."""
    z = logits.to(torch.float32)
    if not is_block("logits", z.shape[-1], vocab, dist):
        logp = torch.log_softmax(z, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]
    group, r, _ = dist_group(dist)
    m = z.detach().amax(dim=-1, keepdim=True)
    _all_reduce(m, group, tdist.ReduceOp.MAX)
    zs = z - m
    total = _ReduceFromModel.apply(torch.exp(zs).sum(dim=-1), group)
    local, inside = _local(labels, r, z.shape[-1])
    picked = torch.gather(zs, -1, local[..., None])[..., 0].masked_fill(~inside, 0)
    return torch.log(total) - _ReduceFromModel.apply(picked, group)


def vocab_argmax(logits: torch.Tensor, vocab: int, dist) -> torch.Tensor:
    """The greedy pick over the last dim (the first of equal maxima, as
    ``argmax``), int64; ``logits`` whole or this rank's vocabulary block."""
    if not is_block("logits", logits.shape[-1], vocab, dist):
        return logits.argmax(dim=-1)
    group, r, _ = dist_group(dist)
    best, idx = logits.max(dim=-1)
    top = best.clone()
    _all_reduce(top, group, tdist.ReduceOp.MAX)
    pick = torch.where(best == top, idx + r * logits.shape[-1],
                       torch.full_like(idx, torch.iinfo(torch.int64).max))
    _all_reduce(pick, group, tdist.ReduceOp.MIN)
    return pick


# --------------------------------------------------------------------------
# The gated MLP's w_in: storage blocks <-> compute blocks.
# --------------------------------------------------------------------------

def _gated_sources(n: int, r: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Where rank ``r`` of ``n`` finds its compute block's two halves, the
    gate columns [r·f, (r+1)·f) and the up columns ff + [r·f, (r+1)·f) of a
    [gate | up] w_in (f = ff / n): (storage rank, offset in f within its
    block of 2f columns) for each."""
    return (r // 2, r % 2), ((n + r) // 2, (n + r) % 2)


def _gated_exchange(t: torch.Tensor, mesh, axis: str, to_compute: bool) -> torch.Tensor:
    """One exchange over the model group along ``t``'s last dim (2f columns
    a rank): storage blocks to compute blocks, or back."""
    from repro_torch.comms import routes

    group, r, n = model_group(mesh, axis)
    if group is None:
        return t
    f = t.shape[-1] // 2
    piece = lambda x, k: x.narrow(-1, k * f, f)  # noqa: E731
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    sends, recvs = [], []
    # one move for each (compute rank d, half h): piece ``off`` of storage
    # rank ``src``'s block is half ``h`` of d's compute block
    for d in range(n):
        for h, (src, off) in enumerate(_gated_sources(n, d)):
            frm, frm_k, to, to_k = (src, off, d, h) if to_compute else (d, h, src, off)
            if frm == r and to == r:
                piece(out, to_k).copy_(piece(t, frm_k))
            elif frm == r:
                sends.append((piece(t, frm_k).contiguous(), to))
            elif to == r:
                dst = piece(out, to_k)
                recvs.append((t.new_empty(dst.shape), frm, dst))
    if sends or recvs:
        routes.send_recv(sends, [(buf, frm) for buf, frm, _ in recvs], group)
        for buf, _, dst in recvs:
            dst.copy_(buf)
    return out


def gated_to_compute(w: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """A gated MLP's w_in (..., 2f) from this rank's storage block (columns
    [r·2f, (r+1)·2f) of [gate | up]) to its compute block (its gate columns
    beside the same up columns), by one exchange over the model axis."""
    return _gated_exchange(w, mesh, axis, to_compute=True)


def gated_to_storage(g: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The inverse of :func:`gated_to_compute` (a gradient back to the
    storage block)."""
    return _gated_exchange(g, mesh, axis, to_compute=False)

"""Tensor parallelism over the mesh's model axis: the operators with which a
step splits its compute as the reference's GSPMD splits it.

The reference jits its steps with ``param_shardings`` (and
``cache_shardings``), and GSPMD then splits every product over "model".
Here each rank is a process, so the split is written out, Megatron-style:

* attention: the rank's query heads and their KV heads (column-parallel
  ``wq``/``wk``/``wv``), then the row-parallel ``wo`` and one all-reduce;
* the dense MLP: the rank's FF columns of ``w_in`` (column-parallel), the
  same rows of ``w_out`` (row-parallel), one all-reduce;
* cross-attention: as attention, its K/V from the frontend on the rank's
  KV heads;
* RWKV's time-mix: the rank's heads' channels of ``wr``/``wk``/``wv``/``wg``
  and of the decay's ``decay_B`` (column-parallel), the decay's ``decay_A``
  on the rank's rows of its input (a partial sum, one all-reduce), the WKV
  recurrence and group norm on the rank's heads, the row-parallel ``wo``
  and one all-reduce; its channel-mix: ``cm_k`` column- and ``cm_v``
  row-parallel, the ``cm_v`` output reduce-scattered over channels
  (:func:`scatter_to_model`), gated there by the rank's columns of
  ``cm_r``, and all-gathered (:func:`gather_from_model`);
* the vocabulary: the rank's rows of the embedding table (a masked lookup
  and an all-reduce), its logits of the unembedding, and the cross-entropy
  and greedy argmax over vocabulary blocks.

:func:`copy_to_model` (identity forward, all-reduce backward) puts a
replicated activation into a column-parallel product; :func:`reduce_from_model`
(all-reduce forward, identity backward) sums a row-parallel product's
partial outputs.  With them every rank of the model axis holds the same
replicated activations and the same loss, each split weight's gradient is
the rank's block of the whole one, and each replicated weight's gradient is
the whole one; a whole leaf that a rank uses only in part
(:func:`model_block`) has its gradient summed over the model axis, so it
too is the whole one.  Every collective goes through ``comms.routes``, so the
dry-run's counter sees it; with a tracer on each all-reduce is a
``tp.allreduce`` span, each reduce-scatter a ``tp.scatter`` and each
all-gather a ``tp.gather`` (the card synchronised at both ends).

A layer tells its weights' blocks from whole ones by their shapes against
the config (:func:`is_block`): a whole weight computes whole on every rank,
as serve's world passes them, and a shape that is neither raises.

Where a decode step's batch does not split over the data axes (batch 1 at
``long_500k``), the reference's GSPMD also computes on the weights' FSDP
blocks and the KV caches' sequence chunks over "data"; the step's
``DistContext.data_split`` names those axes and the operators at the end of
this module write that split out, without gradients (decode only): a
column-parallel product contracts over the rank's block of its input's
channels (:func:`data_block`) and its partial sums are all-reduced
(:func:`reduce_from_data`), a row-parallel one writes the rank's block of
its output's channels, all-gathered after the model all-reduce
(:func:`gather_from_data`), and attention over the rank's sequence chunk
combines its softmax with the other chunks' (:func:`combine_over_data`).
A layer tells data blocks from whole weights by :func:`is_data_block`.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

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


def _traced(name: str, t: torch.Tensor, run) -> None:
    """``run()``, a collective reading ``t``; with a tracer on, inside a span
    ``name`` that starts and ends on an idle card."""
    if not trace.is_active():
        run()
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    with trace.span(name, bytes=t.numel() * t.element_size()):
        run()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def _all_reduce(t: torch.Tensor, group, op=tdist.ReduceOp.SUM) -> None:
    from repro_torch.comms import routes

    _traced("tp.allreduce", t, lambda: routes.all_reduce(t, group, op))


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


class _ScatterToModel(torch.autograd.Function):
    """The sum over the group of ``x`` (..., n·c), this rank's block of c
    along the last dim (one reduce-scatter); the backward all-gathers the
    blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's block ``x`` (..., c) joined along the last dim in group
    order (one all-gather); the backward keeps this rank's block of the
    gradient (every rank holds the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rank, ctx.c = group, tdist.get_rank(group), x.shape[-1]
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.c, ctx.c).contiguous(), None


class _GatherToModel(torch.autograd.Function):
    """Every rank's block ``x`` (..., c) joined along the last dim in group
    order (one all-gather), each rank then using its own part of the whole;
    the backward sums the ranks' gradients and keeps this rank's block (one
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_last(g, ctx.group), None


def _reduce_scatter_last(x: torch.Tensor, group) -> torch.Tensor:
    from repro_torch.comms import routes

    n = tdist.get_world_size(group)
    inp = x.movedim(-1, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // n,) + tuple(inp.shape[1:]))
    _traced("tp.scatter", inp, lambda: routes.reduce_scatter(out, inp, group))
    return out.movedim(0, -1)


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    from repro_torch.comms import routes

    n = tdist.get_world_size(group)
    inp = x.movedim(-1, 0).contiguous()
    out = inp.new_empty((n * inp.shape[0],) + tuple(inp.shape[1:]))
    _traced("tp.gather", inp, lambda: routes.all_gather(out, inp, group))
    return out.movedim(0, -1)


def copy_to_model(x: torch.Tensor, dist) -> torch.Tensor:
    """``x``, alike on every rank of the model axis, into a product split over
    it: the backward sums the ranks' partial gradients."""
    group = dist_group(dist)[0]
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, dist) -> torch.Tensor:
    """The sum over the model axis of the ranks' partial outputs ``x``."""
    group = dist_group(dist)[0]
    return x if group is None else _ReduceFromModel.apply(x, group)


def scatter_to_model(x: torch.Tensor, dist) -> torch.Tensor:
    """This rank's block, along the last dim, of the sum over the model axis
    of the ranks' partial outputs ``x``: a reduce-scatter, the bytes of an
    all-reduce's first half."""
    return _ScatterToModel.apply(x, dist_group(dist)[0])


def gather_from_model(x: torch.Tensor, dist) -> torch.Tensor:
    """The ranks' blocks ``x`` joined along the last dim over the model axis,
    alike on every rank (the inverse of :func:`scatter_to_model`'s split)."""
    return _GatherFromModel.apply(x, dist_group(dist)[0])


def gather_to_model(x: torch.Tensor, dist) -> torch.Tensor:
    """The ranks' blocks ``x`` joined along the last dim over the model axis,
    into products that differ by rank (the RG-LRU's gates across ranks): the
    backward sums the ranks' gradients of the whole and keeps this rank's
    block, a reduce-scatter (:func:`gather_from_model`'s backward only
    narrows, right where every rank consumes the whole alike)."""
    return _GatherToModel.apply(x, dist_group(dist)[0])


def model_block(t: torch.Tensor, dim: int, dist) -> torch.Tensor:
    """This rank's block along ``dim`` of a leaf ``t`` held whole on every
    rank of the model axis (its products split, its storage not); the
    backward sums the gradient over the axis, so the whole leaf's gradient
    is whole on every rank."""
    _, r, n = dist_group(dist)
    size = t.shape[dim] // n
    return copy_to_model(t, dist).narrow(dim, r * size, size)


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


# --------------------------------------------------------------------------
# The data axes: decode on the FSDP blocks and the caches' sequence chunks.
# --------------------------------------------------------------------------

def data_size(dist) -> int:
    """The number of ranks over ``dist.data_split`` (1: no data split)."""
    if dist is None or not dist.data_split:
        return 1
    sizes = mesh_shape(dist.mesh)
    return math.prod(sizes.get(a, 1) for a in dist.data_split)


def data_group(dist) -> Tuple[Optional[object], int, int]:
    """(the process group of ``dist.data_split``, this rank's index on it, its
    size); (None, 0, 1) where there is no data split."""
    if data_size(dist) == 1:
        return None, 0, 1
    if len(dist.data_split) == 1:
        return model_group(dist.mesh, dist.data_split[0])
    from repro_torch.launch.mesh import axes_group

    group = axes_group(dist.mesh, dist.data_split)
    return group, tdist.get_rank(group), data_size(dist)


def is_data_block(what: str, have: int, whole: int, dist) -> bool:
    """Whether a dim of ``have`` is this rank's block of a dim of ``whole``
    split over the data axes of ``dist.data_split`` (False: it is whole).
    Raises on anything else, as :func:`is_block`."""
    if have == whole:
        return False
    n = data_size(dist)
    if n > 1 and whole % n == 0 and have == whole // n:
        return True
    raise ValueError(f"{what}: {have} of {whole} is neither whole nor this rank's block "
                     f"over data axes {() if dist is None else dist.data_split} of {n}")


def _forward_only(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"tp.{what}: the data-axis operators serve decode only and have "
                           "no backward")


def data_block(x: torch.Tensor, dist) -> torch.Tensor:
    """This rank's block over the data axes of the last dim of ``x``, alike on
    every rank of them (the input of a product whose weight rows are the
    rank's FSDP block)."""
    _forward_only(x, "data_block")
    _, r, n = data_group(dist)
    if x.shape[-1] % n:
        raise ValueError(f"tp.data_block: {x.shape[-1]} channels over {n} data ranks")
    c = x.shape[-1] // n
    return x.narrow(-1, r * c, c)


def reduce_from_data(xs: List[torch.Tensor], dist) -> List[torch.Tensor]:
    """The sums over the data axes of the ranks' partial products ``xs``: one
    all-reduce of their concatenation in f32, each sum back in its dtype."""
    group = data_group(dist)[0]
    if group is None:
        return list(xs)
    for x in xs:
        _forward_only(x, "reduce_from_data")
    flat = torch.cat([x.reshape(-1).float() for x in xs])
    _all_reduce(flat, group)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
        at += x.numel()
    return out


def gather_from_data(x: torch.Tensor, dist) -> torch.Tensor:
    """The ranks' blocks ``x`` (..., c) joined along the last dim over the
    data axes (a row-parallel product's output channels), alike on every
    rank: one all-gather."""
    group = data_group(dist)[0]
    if group is None:
        return x
    _forward_only(x, "gather_from_data")
    return _all_gather_last(x, group)


def merge_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                  reduce: Callable[[torch.Tensor, object], None]) -> torch.Tensor:
    """Softmax attention's output (..., dh) from its parts over a split key
    axis, each part's row maximum ``m`` (...), sum of exp(logit - m) ``l``
    (...) and unnormalised output ``o`` (..., dh), f32: M = max m, then
    sum(o·e^(m-M)) / sum(l·e^(m-M)).  ``reduce(t, op)`` reduces ``t`` over the
    parts in place (``ReduceOp.MAX``, then one ``SUM`` of l and o together).
    A part whose every key is masked (m near ``NEG_INF``) weighs e^(m-M) = 0."""
    top = m.clone()
    reduce(top, tdist.ReduceOp.MAX)
    w = torch.exp(m - top)
    lo = torch.cat([(l * w)[..., None], o * w[..., None]], dim=-1)
    reduce(lo, tdist.ReduceOp.SUM)
    return lo[..., 1:] / lo[..., :1]


def combine_over_data(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                      dist) -> torch.Tensor:
    """:func:`merge_softmax` of this rank's part over its sequence chunk and
    the other data ranks' parts: one all-reduce (max), then one (sum)."""
    group = data_group(dist)[0]
    if group is None:
        return o / l[..., None]
    for t in (m, l, o):
        _forward_only(t, "combine_over_data")
    return merge_softmax(m, l, o, lambda t, op: _all_reduce(t, group, op))

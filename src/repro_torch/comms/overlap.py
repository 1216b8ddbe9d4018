"""Compute/communication overlap utilities, ported from
``repro.comms.overlap``.

* ``microbatched_grads`` — gradient accumulation where each microbatch's
  gradient can be reduced as soon as it exists (``reduce_each``), so the
  reduction of microbatch i can overlap the backward of microbatch i+1,
  instead of one monolithic end-of-step all-reduce.
* ``chunked_collective`` — split one big collective into ``n_chunks``
  independent calls, which can be interleaved with compute (and, across
  pods, spread over rails: the paper's split-the-payload insight in time
  rather than space).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.convert import tree_leaves, tree_map, tree_unflatten


def microbatched_grads(
    loss_fn: Callable,  # (params, batch) -> scalar loss
    params,
    batch,  # leading dim = n_micro * per_micro
    n_micro: int,
    reduce_each: Optional[Callable] = None,  # e.g. lambda g: allreduce over 'data'
):
    """Gradient accumulation over ``n_micro`` microbatches.

    If ``reduce_each`` is given it is applied to *each microbatch gradient*
    before it is added (the overlap-friendly structure); otherwise the
    caller reduces the accumulated gradient once at the end.  Returns
    (mean_loss, grads) with grads averaged over microbatches; ``params`` is
    a tree of tensors and is not changed."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    acc_loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = [torch.zeros_like(p) for p in leaves]
    for m in range(n_micro):
        mb = tree_map(lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                                          + tuple(x.shape[1:]))[m], batch)
        loss = loss_fn(live, mb)
        grads = torch.autograd.grad(loss, leaves)
        if reduce_each is not None:
            grads = tree_leaves(reduce_each(tree_unflatten(params, list(grads))))
        acc_loss = acc_loss + loss.detach()
        acc = [a + g for a, g in zip(acc, grads)]
    scale = 1.0 / n_micro
    return acc_loss * scale, tree_unflatten(params, [g * scale for g in acc])


def chunked_collective(
    collective: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    n_chunks: int,
    axis: int = 1,
    pad_value: Optional[float] = 0,
) -> torch.Tensor:
    """Apply ``collective`` to ``n_chunks`` independent slices along ``axis``
    and concatenate the results; numerics are those of one monolithic call.
    The default ``axis=1`` is the reference's (axis 0 is the replica dim of
    its global arrays); a rank's slot here has no replica dim, so callers
    pass the axis.

    When ``axis``'s length does not divide ``n_chunks``, the input is padded
    with ``pad_value`` and the padding removed from each chunk's output.
    ``pad_value`` must be the identity of the collective's reduction (0 for
    sum — the default; ``+inf`` for min, ``-inf`` for max); pass
    ``pad_value=None`` to reject padding outright (ValueError) when no safe
    identity exists.  Collectives that multiply the chunk axis (all-gather
    along it returns one padded block per participant) are un-padded
    per-block, not by slicing the concatenated output — the blocks keep
    their interleaved order and only the padding is dropped.
    """
    n = x.shape[axis]
    pad = (-n) % n_chunks
    if pad == 0:
        # equal chunks give equal outputs: write each into its slice of one
        # output as it comes, so no list of outputs is held beside it
        parts = torch.split(x, n // n_chunks, dim=axis)
        first = collective(parts[0])
        m = first.shape[axis]
        shape = list(first.shape)
        shape[axis] = m * n_chunks
        out = first.new_empty(shape)
        out.narrow(axis, 0, m).copy_(first)
        del first
        for i, p in enumerate(parts[1:], start=1):
            out.narrow(axis, i * m, m).copy_(collective(p))
        return out
    if pad_value is None:
        raise ValueError(
            f"chunked_collective: axis {axis} length {n} is not divisible by "
            f"n_chunks={n_chunks} and pad_value=None forbids padding (no "
            f"safe identity for this collective's reduction)"
        )
    fill = list(x.shape)
    fill[axis] = pad
    xp = torch.cat([x, torch.full(fill, pad_value, dtype=x.dtype, device=x.device)], dim=axis)
    chunk_len = xp.shape[axis] // n_chunks
    outs = [collective(p) for p in torch.split(xp, chunk_len, dim=axis)]
    factor, rem = divmod(outs[0].shape[axis], chunk_len)
    if rem:
        raise ValueError(
            f"chunked_collective: collective changed the chunk axis from "
            f"{chunk_len} to {outs[0].shape[axis]} — not an integer multiple, "
            f"so padding cannot be removed faithfully"
        )
    trimmed = []
    for i, out in enumerate(outs):
        # valid (unpadded) length of chunk i: padding lives at the global end
        valid = min(max(n - i * chunk_len, 0), chunk_len)
        if valid == 0:
            continue  # chunk was pure padding
        if valid == chunk_len:
            trimmed.append(out)
            continue
        # the output holds `factor` blocks, each a padded chunk image: drop
        # the padding from every block, preserving block order
        moved = out.movedim(axis, 0)
        blocks = moved.reshape((factor, chunk_len) + tuple(moved.shape[1:]))
        moved = blocks[:, :valid].reshape((factor * valid,) + tuple(moved.shape[1:]))
        trimmed.append(moved.movedim(0, axis))
    return torch.cat(trimmed, dim=axis)

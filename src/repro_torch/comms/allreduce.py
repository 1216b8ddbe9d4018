"""All-reduce strategies, ported from ``repro.comms.allreduce``.

Contract of every public wrapper: each rank passes its own contribution,
the reference's ``x[i]`` for the rank at row-major coordinate i over the
reduce axes, and gets back its slot of the reference's output: the sum of
every rank's contribution.  The input is left as it was.

Strategies:

* ``flat``         — one all-reduce over the group of all the axes.
* ``hierarchical`` — reduce-scatter over the fast axes, all-reduce over the
                     slow axis on the 1/k shards, all-gather back over the
                     fast axes.  The paper's "split the slow-tier traffic
                     over every injecting agent" optimization (§IV,
                     Dup-Devptr).
* ``ring``         — the reference's ring, step by step: 2(k-1) exchanges
                     with the next rank of one axis, each sending forward
                     only, so the sums happen in the reference's order.

The ``*_inner`` functions are the building blocks a rank's own program
calls; they take the mesh, which names the groups (the reference's take
axis names bound by ``shard_map``), and read the axis sizes from it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.comms import routes
from repro_torch.launch.mesh import axes_group, axes_index, axes_size, mesh_axes

# --------------------------------------------------------------------------
# Inner building blocks.  x: this rank's contribution.
# --------------------------------------------------------------------------


def _pad_lead(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, int]:
    pad = (-x.shape[0]) % k
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x, pad


def _scatter_lead(x: torch.Tensor, group, k: int) -> torch.Tensor:
    """Reduce-scatter along dim 0 (tiled): this rank's 1/k block of the sum."""
    out = x.new_empty((x.shape[0] // k,) + tuple(x.shape[1:]))
    routes.reduce_scatter(out, x.contiguous(), group)
    return out


def _gather_lead(x: torch.Tensor, group, k: int) -> torch.Tensor:
    """All-gather along dim 0 (tiled)."""
    out = x.new_empty((x.shape[0] * k,) + tuple(x.shape[1:]))
    routes.all_gather(out, x.contiguous(), group)
    return out


def allreduce_flat_inner(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    routes.all_reduce(out, axes_group(mesh, axes))
    return out


def allreduce_hier_inner(
    x: torch.Tensor, mesh: DeviceMesh, slow_axis: str, fast_axes: Sequence[str]
) -> torch.Tensor:
    """RS(fast) -> all-reduce(slow) on shards -> AG(fast)."""
    lead = x.shape[0]
    shard, pad = _pad_lead(x, axes_size(mesh, fast_axes))
    sizes = mesh_axes(mesh)
    for a in fast_axes:
        shard = _scatter_lead(shard, axes_group(mesh, a), sizes[a])
    shard = allreduce_flat_inner(shard, mesh, (slow_axis,))
    out = shard
    for a in reversed(tuple(fast_axes)):
        out = _gather_lead(out, axes_group(mesh, a), sizes[a])
    return out[:lead] if pad else out


def allreduce_ring_inner(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Ring reduce-scatter + ring all-gather, sending to the next rank of
    ``axis`` and receiving from the previous one (2(k-1) steps)."""
    k = mesh_axes(mesh)[axis]
    if k == 1:
        return x.clone()
    lead = x.shape[0]
    x, pad = _pad_lead(x, k)
    chunks = x.reshape((k, -1) + tuple(x.shape[1:]))
    group = axes_group(mesh, axis)
    idx = axes_index(mesh, axis)
    nxt, prv = (idx + 1) % k, (idx - 1) % k

    def shift(buf: torch.Tensor) -> torch.Tensor:
        recv = torch.empty_like(buf, memory_format=torch.contiguous_format)
        routes.send_recv([(buf, nxt)], [(recv, prv)], group)
        return recv

    # Reduce-scatter: after k-1 steps rank idx owns the full sum of chunk
    # (idx+1) mod k.  Each step: send the current partial, add the local
    # chunk of the partial received.
    buf = chunks[idx]
    for i in range(k - 1):
        buf = shift(buf) + chunks[(idx - i - 1) % k]
    own_id = (idx + 1) % k

    # All-gather the reduced chunks around the ring.
    out = torch.zeros_like(chunks)
    out[own_id] = buf
    for i in range(k - 1):
        buf = shift(buf)
        out[(own_id - i - 1) % k] = buf
    out = out.reshape((k * out.shape[1],) + tuple(out.shape[2:]))
    return out[:lead] if pad else out


# --------------------------------------------------------------------------
# Wrappers.
# --------------------------------------------------------------------------

def allreduce_flat(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    return allreduce_flat_inner(x, mesh, tuple(axes))


def allreduce_hierarchical(
    x: torch.Tensor, mesh: DeviceMesh, slow_axis: str, fast_axes: Sequence[str]
) -> torch.Tensor:
    return allreduce_hier_inner(x, mesh, slow_axis, tuple(fast_axes))


def allreduce_ring(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    return allreduce_ring_inner(x, mesh, axis)


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's contribution (lead dim n, a multiple of the axis size k)
    -> its 1/k block of the sum along dim 0: rows [i·n/k, (i+1)·n/k)."""
    k = mesh_axes(mesh)[axis]
    if x.shape[0] % k:
        raise ValueError(f"reduce_scatter: leading dim {x.shape[0]} is not a multiple of "
                         f"the {axis!r} axis size {k}")
    return _scatter_lead(x, axes_group(mesh, axis), k)


def auto_allreduce_strategy(
    x: torch.Tensor,
    mesh: DeviceMesh,
    slow_axis: str = "pod",
    fast_axes: Sequence[str] = ("data",),
) -> str:
    """Model-driven strategy pick for :func:`allreduce`.

    Consults :mod:`repro_torch.comms.autotune` with this mesh's shape over
    the participating axes and the per-replica payload, this rank's slot
    (``x.numel() * x.element_size()``): the reference's pick for the same
    mesh and payload.  Repeat consultations are plan-cache probes."""
    from repro_torch.comms.autotune import select_allreduce_strategy

    sizes = mesh_axes(mesh)
    if slow_axis not in sizes:
        return "flat"
    bytes_per_chip = float(x.numel() * x.element_size())
    # only the participating axes: other mesh axes would inflate the modeled
    # per-pod chip count and price the wrong machine
    shape = {a: sizes[a] for a in (slow_axis, *fast_axes) if a in sizes}
    return select_allreduce_strategy(shape, bytes_per_chip)


def allreduce(
    x: torch.Tensor,
    mesh: DeviceMesh,
    strategy: str = "flat",
    slow_axis: str = "pod",
    fast_axes: Sequence[str] = ("data",),
) -> torch.Tensor:
    """Strategy-dispatched all-reduce over (slow_axis, *fast_axes).

    ``strategy="auto"`` asks the performance models (see
    :func:`auto_allreduce_strategy`).  As in the reference, ``ring``
    reduces over ``fast_axes[0]`` only."""
    sizes = mesh_axes(mesh)
    if strategy == "auto":
        strategy = auto_allreduce_strategy(x, mesh, slow_axis, fast_axes)
    if strategy == "flat" or slow_axis not in sizes:
        axes = [a for a in (slow_axis, *fast_axes) if a in sizes]
        return allreduce_flat(x, mesh, axes)
    if strategy == "hierarchical":
        return allreduce_hierarchical(x, mesh, slow_axis, tuple(fast_axes))
    if strategy == "ring":
        return allreduce_ring(x, mesh, fast_axes[0])
    raise ValueError(f"unknown allreduce strategy {strategy!r}")

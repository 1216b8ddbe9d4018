"""All-to-all strategies (the paper's §VI case study), ported from
``repro.comms.alltoall``.

Contract: each rank passes its slot, the reference's ``x[i]``: a (k,
*payload) tensor whose block j goes to the rank at row-major coordinate j
over the axes (k = the product of their sizes).  It gets back its slot of
the reference's output: block j is what rank j sent it (``out[i, j] =
x[j, i]``).

* ``direct``       — one all-to-all over the group of the axes (every pair
                     exchanges directly; k-1 messages a rank).
* ``hierarchical`` — two hops: an all-to-all over the *inner* (fast) axis,
                     splitting the inner destination coordinate, then one
                     over the *outer* (slow) axis with every inner rank
                     injecting at once (3-step + Dup-Devptr analogue: the
                     slow tier sees k_outer-1 messages a rank, not k-1).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.comms import routes
from repro_torch.launch.mesh import axes_group, axes_size, mesh_axes

# --------------------------------------------------------------------------
# Inner bodies: x_loc (k, *payload) = the blocks this rank sends.
# --------------------------------------------------------------------------


def _exchange(blocks: torch.Tensor, group) -> torch.Tensor:
    """All-to-all along dim 0: block j goes to group rank j, and block j of
    the result came from group rank j."""
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    routes.all_to_all(out, blocks, group)
    return out


def alltoall_direct_inner(x_loc: torch.Tensor, mesh: DeviceMesh,
                          axes: Sequence[str]) -> torch.Tensor:
    """x_loc: (k, *payload) send blocks -> (k, *payload) received blocks."""
    return _exchange(x_loc, axes_group(mesh, tuple(axes)))


def alltoall_hier_inner(x_loc: torch.Tensor, mesh: DeviceMesh, outer_axis: str,
                        inner_axis: str) -> torch.Tensor:
    """Two-hop all-to-all, the reference's block order.

    Rank (o, i) over (outer, inner) of sizes (O, I); x_loc is ordered by
    destination d = o'·I + i'.  Hop 1 (fast tier), over inner_axis: inner
    peer s receives every [o', s] block, so afterwards rank (o, i) holds
    hop1[o', s] = the block from (o, s) for (o', i).  Hop 2 (slow tier), over
    outer_axis on o': afterwards [src_o, s] is the block from (src_o, s) for
    this rank, which flattens to the direct all-to-all's order."""
    sizes = mesh_axes(mesh)
    outer, inner = sizes[outer_axis], sizes[inner_axis]
    k, *payload = x_loc.shape
    if k != outer * inner:
        raise ValueError(f"alltoall_hier_inner: {k} blocks for a {outer} x {inner} mesh")
    blocks = x_loc.reshape(outer, inner, *payload)
    # hop 1: the all-to-all splits dim 0, so put the inner destination first
    recv = _exchange(blocks.transpose(0, 1), axes_group(mesh, inner_axis))  # [s, o']
    hop1 = recv.transpose(0, 1)  # [o', s]
    hop2 = _exchange(hop1, axes_group(mesh, outer_axis))  # [src_o, s]
    return hop2.reshape(k, *payload)


# --------------------------------------------------------------------------
# Wrappers.
# --------------------------------------------------------------------------

def _check(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> None:
    k = axes_size(mesh, axes)
    if x.ndim < 1 or x.shape[0] != k:
        raise ValueError(f"alltoall expects a slot (k, *payload) with k={k}, got "
                         f"{tuple(x.shape)}")


def alltoall_direct(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    _check(x, mesh, axes)
    return alltoall_direct_inner(x, mesh, tuple(axes))


def alltoall_hierarchical(x: torch.Tensor, mesh: DeviceMesh, outer_axis: str,
                          inner_axis: str) -> torch.Tensor:
    _check(x, mesh, (outer_axis, inner_axis))
    return alltoall_hier_inner(x, mesh, outer_axis, inner_axis)


def auto_alltoall_strategy(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> str:
    """Model-driven strategy pick for :func:`alltoall`: consults
    :mod:`repro_torch.comms.autotune` with this mesh's shape over ``axes``
    and the per-pair block size, this rank's slot over k blocks: the
    reference's pick for the same mesh and payload."""
    from repro_torch.comms.autotune import select_alltoall_strategy

    axes = tuple(axes)
    k = axes_size(mesh, axes)
    block_bytes = float(x.numel() // max(k, 1)) * x.element_size()
    # only the participating axes: other mesh axes would inflate the modeled
    # per-pod chip count and price the wrong machine
    sizes = mesh_axes(mesh)
    shape = {a: sizes[a] for a in axes}
    return select_alltoall_strategy(
        shape, block_bytes, n_msgs=max(k - 1, 1),
        crosses_pod=("pod" in axes and len(axes) == 2),
    )


def alltoall(
    x: torch.Tensor,
    mesh: DeviceMesh,
    axes: Sequence[str],
    strategy: str = "direct",
) -> torch.Tensor:
    """Strategy-dispatched all-to-all over the given mesh axes.

    ``strategy="auto"`` asks the performance models (see
    :func:`auto_alltoall_strategy`)."""
    axes = tuple(axes)
    if strategy == "auto":
        strategy = auto_alltoall_strategy(x, mesh, axes)
    if strategy == "direct" or len(axes) == 1:
        return alltoall_direct(x, mesh, axes)
    if strategy == "hierarchical":
        if len(axes) != 2:
            raise ValueError("hierarchical alltoall needs (outer, inner) axes")
        return alltoall_hierarchical(x, mesh, axes[0], axes[1])
    raise ValueError(f"unknown alltoall strategy {strategy!r}")

"""Point-to-point patterns, ported from ``repro.comms.p2p`` (there built on
``ppermute``): each rank sends to one peer of an axis and receives from
another, all at once (``batch_isend_irecv``)."""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.comms import routes
from repro_torch.launch.mesh import axes_group, axes_index, mesh_axes


def _shift(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int) -> torch.Tensor:
    """Rank i's ``x`` lands on rank (i + shift) mod k of ``axis``."""
    k = mesh_axes(mesh)[axis]
    if shift % k == 0:
        return x.clone(memory_format=torch.contiguous_format)
    idx = axes_index(mesh, axis)
    recv = torch.empty_like(x, memory_format=torch.contiguous_format)
    routes.send_recv([(x, (idx + shift) % k)], [(recv, (idx - shift) % k)],
                     axes_group(mesh, axis))
    return recv


def ring_shift(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Cyclically shift the ranks' blocks by ``shift`` positions around the
    ring of ``axis``: rank (i + shift) mod k gets rank i's ``x``."""
    return _shift(x, mesh, axis, shift)


def halo_exchange(x: torch.Tensor, mesh: DeviceMesh, axis: str, halo: int) -> torch.Tensor:
    """1-D halo exchange of a spatially sharded tensor (the stencil pattern,
    the paper's motivating application class).

    ``x``: (n, *feat), this rank's shard of a length k·n sequence.  Returns
    (n + 2·halo, *feat): the previous rank's last ``halo`` rows, the shard,
    and the next rank's first ``halo`` rows.  The ring is cyclic, as the
    reference's permutations are: rank 0's left halo is rank k-1's edge."""
    from_left = _shift(x[-halo:], mesh, axis, 1)
    from_right = _shift(x[:halo], mesh, axis, -1)
    return torch.cat([from_left, x, from_right], dim=0)

"""All-gather helpers (the FSDP parameter-gathering path), ported from
``repro.comms.allgather``."""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.comms import routes
from repro_torch.launch.mesh import axes_group, mesh_axes


def all_gather_axis(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Gather a tensor sharded on ``axis`` along tensor dim ``dim``: each rank
    passes its shard, the reference's block i along ``dim``, and gets the
    whole tensor, the shards in coordinate order.  The explicit form of the
    FSDP un-shard."""
    k = mesh_axes(mesh)[axis]
    dim = dim % x.ndim
    shard = x.movedim(dim, 0).contiguous()
    out = shard.new_empty((k * shard.shape[0],) + tuple(shard.shape[1:]))
    routes.all_gather(out, shard, axes_group(mesh, axis))
    return out.movedim(0, dim)

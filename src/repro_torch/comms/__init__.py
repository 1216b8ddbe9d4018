"""Mesh collectives with selectable algorithms (strategies), on ``torch.distributed``.

Ported from ``repro.comms``, whose wrappers take one *global* array (the
leading dimension indexes replicas) and run as a ``shard_map`` in one
process.  Here each rank is a process, so every public wrapper
(``allreduce_flat(x, mesh, axes)``, ``reduce_scatter``, ``alltoall_direct``,
``ring_shift``, ``halo_exchange``, ``all_gather_axis``, ...) takes this
rank's slot, the reference's ``x[i]`` for the rank at row-major coordinate
i over the axes, and returns this rank's slot of the reference's output.
The ``*_inner`` functions keep the reference's names and roles, the
building blocks a rank's own program calls, with the mesh as their second
argument.  A mesh is a ``DeviceMesh`` from ``repro_torch.launch.mesh``;
each collective reaches its backend by the route :mod:`.routes` gives it.
Each strategy's communication pattern is explicit and selectable by the
planner (``comms.autotune``).
"""
from repro_torch.comms.allreduce import (
    allreduce,
    allreduce_flat,
    allreduce_hierarchical,
    allreduce_ring,
    auto_allreduce_strategy,
    reduce_scatter,
)
from repro_torch.comms.alltoall import (
    alltoall,
    alltoall_direct,
    alltoall_hierarchical,
    auto_alltoall_strategy,
)
from repro_torch.comms.allgather import all_gather_axis
from repro_torch.comms.p2p import halo_exchange, ring_shift
from repro_torch.comms.autotune import (
    AutotuneRecord,
    active_machine,
    clear_plan_cache,
    explain_bottleneck,
    measured_autotune,
    plan_cache_info,
    select_allreduce_strategy,
    select_alltoall_strategy,
    select_collective_strategy,
    select_moe_dispatch_strategy,
    select_schedule,
    select_transfer_path,
    set_active_machine,
)

__all__ = [k for k in dir() if not k.startswith("_")]

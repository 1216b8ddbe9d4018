"""Model-guided strategy selection (``comms.autotune``).

The reference's collective wrappers (``allreduce``, ``alltoall``,
``allgather``, ``p2p``, ``overlap``) are JAX collectives; their port comes
with distribution.  This package exports autotune's names only.
"""
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

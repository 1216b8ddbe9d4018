"""The paper's primary contribution: data-movement performance models and
the model-driven communication planner.

Layers:
  params    — measured constants (paper Tables I-III) + TPU v5e target specs
  postal    — Eq. (1): segmented postal models
  maxrate   — Eq. (2)/(3): injection caps & multi-message costs
  machine   — MachineSpec/TransportTier registry: declarative machines,
              generic path/strategy evaluation (DESIGN.md §3)
  topology  — Summit/Lassen nodes and TPU pod tori
  paths     — path costs (GPUDirect vs 3-step; TPU direct/staged/multirail)
  fitting   — least-squares (re)fitting of all model parameters
  simulate  — collective strategy cost simulation (paper §VI)
  events    — discrete-event engine: finite resources, queueing, critical
              path, bottleneck_report (DESIGN.md §4)
  schedule  — declarative collective schedules: strategy lowering, the
              ring/Bruck/recursive/node-aware library, schedule search
  planner   — strategy selection consumed by repro_torch.comms
  benchmark — live measurement harness feeding `fitting`; fitted machines
              register via `spec_from_measurements` and plan like built-ins
"""
from repro_torch.core.params import (
    CopyDirection,
    Locality,
    PostalParams,
    Protocol,
    TABLE_I,
    TABLE_II,
    TABLE_III_BETA_N,
    TPU_V5E,
    TpuSystem,
)
from repro_torch.core.postal import (
    SegmentedPostalModel,
    SimplePostalModel,
    crossover_size,
    make_simple,
    paper_model,
)
from repro_torch.core.maxrate import (
    MaxRateParams,
    maxrate_time,
    multi_message_time,
    node_split_time,
    saturating_ppn,
)
from repro_torch.core.topology import (
    GpuNodeTopology,
    LASSEN,
    SINGLE_POD_V5E,
    SUMMIT,
    TWO_POD_V5E,
    TpuPodTopology,
)
from repro_torch.core.machine import (
    MachineSpec,
    Path,
    StrategyDecl,
    TransportTier,
    Traversal,
    get_machine,
    machine_for,
    path_time,
    plan_costs,
    register_machine,
    registered_machines,
    simulate_strategies,
    strategy_time,
)
from repro_torch.core.paths import (
    TpuPathModels,
    gpudirect_time,
    memcpy_time,
    three_step_time,
)
from repro_torch.core.events import (
    BottleneckReport,
    Resource,
    Schedule,
    SimResult,
    Step,
    bottleneck_report,
    run_schedule,
)
from repro_torch.core.schedule import (
    best_schedule,
    candidate_schedules,
    chain_schedules,
    compose_schedules,
    flat_ring_allreduce_schedule,
    hierarchical_allreduce_schedule,
    lower_path,
    lower_strategy,
    moe_alltoall_schedules,
    search_schedules,
    simulate_schedule,
)
from repro_torch.core.planner import (
    CollectiveKind,
    Plan,
    message_count_crossover,
    plan_gpu_collective,
    plan_gpu_messages,
    plan_messages,
    plan_moe_alltoall,
    plan_schedule_search,
    plan_tpu_allreduce,
    plan_tpu_crosspod,
    schedule_search_report,
)
from repro_torch.core import events, fitting, schedule, simulate, benchmark

__all__ = [k for k in dir() if not k.startswith("_")]

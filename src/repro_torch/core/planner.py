"""Model-driven communication planner — the paper's optimization, as an API.

Given a logical collective (kind, payload, message structure) and a
topology, the planner evaluates every implementable strategy with the
performance models and returns a ranked plan.  ``comms/`` consumes the
decision to pick a shard_map lowering.

The planner is machine-agnostic: it asks the registry
(:mod:`repro_torch.core.machine`) for the topology's :class:`MachineSpec` and
ranks that spec's declared planning variants / strategies with the generic
evaluators.  The paper machines reproduce the §V/§VI decisions (3-step vs
GPUDirect crossovers) exactly; a machine fitted live by
:func:`repro_torch.core.benchmark.spec_from_measurements` plans the same way.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import simulate
from repro_torch.core.machine import (
    MachineSpec,
    machine_for,
    path_time,
    plan_costs,
    resolve_spec as _spec,
)
from repro_torch.core.params import Locality
from repro_torch.core.topology import GpuNodeTopology, TpuPodTopology


class CollectiveKind(enum.Enum):
    P2P = "p2p"  # point-to-point message batch
    ALLTOALL = "alltoall"
    ALLTOALLV = "alltoallv"
    ALLREDUCE = "allreduce"
    ALLGATHER = "allgather"
    REDUCESCATTER = "reducescatter"


@dataclasses.dataclass(frozen=True)
class Plan:
    strategy: str
    predicted_time: float
    alternatives: Tuple[Tuple[str, float], ...]  # (strategy, time) sorted asc

    @property
    def ranking(self) -> List[str]:
        return [name for name, _ in self.alternatives]

    def speedup_over(self, strategy: str) -> float:
        costs = dict(self.alternatives)
        return costs[strategy] / self.predicted_time


def _mk_plan(costs: Dict[str, float]) -> Plan:
    ranked = tuple(sorted(costs.items(), key=lambda kv: kv[1]))
    return Plan(strategy=ranked[0][0], predicted_time=ranked[0][1], alternatives=ranked)


# --------------------------------------------------------------------------
# Message-level planning: rank the machine's declared path variants.
# --------------------------------------------------------------------------

def plan_messages(
    machine: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    locality: Locality = Locality.OFF_NODE,
    dedup_factor: float = 1.0,
) -> Plan:
    """Choose the path for n messages of s bytes from one device (paper §V),
    for ANY registered machine (built-in, GH200-like, or live-fitted)."""
    spec = _spec(machine)
    return _mk_plan(
        plan_costs(
            spec, nbytes_per_msg, n_msgs,
            locality=locality, dedup_factor=dedup_factor,
        )
    )


def plan_gpu_messages(
    topo: GpuNodeTopology,
    nbytes_per_msg: float,
    n_msgs: int = 1,
    locality: Locality = Locality.OFF_NODE,
    dedup_factor: float = 1.0,
) -> Plan:
    """Topology-flavoured :func:`plan_messages` (kept for the paper API)."""
    return plan_messages(
        machine_for(topo), nbytes_per_msg, n_msgs,
        locality=locality, dedup_factor=dedup_factor,
    )


def message_count_crossover(
    topo,
    nbytes_per_msg: float,
    max_msgs: int = 1024,
    cores_per_gpu: int = 1,
) -> Optional[int]:
    """Smallest message count at which the staged path beats the direct path
    (paper Fig 5: ~10 on Summit, ~100 on Lassen at 1 KiB).

    One vectorized evaluation over the whole n grid — both path costs
    broadcast over ``n_msgs``.
    """
    spec = machine_for(topo)
    direct_path, staged_path = spec.crossover_paths
    conc = int(spec.fact("injectors_per_node", 1))
    ns = np.arange(1, max_msgs + 1, dtype=np.float64)
    direct = path_time(spec, direct_path, nbytes_per_msg, ns, concurrency=conc)
    staged = path_time(
        spec, staged_path, nbytes_per_msg, ns,
        lanes=cores_per_gpu, concurrency=conc,
    )
    hits = np.nonzero(np.asarray(staged) < np.asarray(direct))[0]
    return int(hits[0]) + 1 if hits.size else None


def plan_gpu_collective(
    topo: GpuNodeTopology, nodes: int, msg_bytes: float, kind: CollectiveKind
) -> Plan:
    p = simulate.CollectiveProblem(
        topo=topo,
        nodes=nodes,
        msg_bytes=msg_bytes,
        split_messages=(kind == CollectiveKind.ALLTOALLV),
    )
    return _mk_plan(simulate.simulate_all(p))


# --------------------------------------------------------------------------
# Schedule search: rank event-engine-simulated schedules — every declared
# strategy plus the library algorithms (Bruck, node-aware two-level, ...)
# the closed forms cannot express (DESIGN.md §4).
# --------------------------------------------------------------------------

def plan_schedule_search(
    machine: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    *,
    peers: Optional[int] = None,
    split_messages: bool = False,
    include_library: bool = True,
    capacity_overrides=None,
) -> Plan:
    """Rank every applicable schedule by simulated makespan.

    Unlike :func:`plan_gpu_collective` (closed forms over the fixed declared
    strategies), this lowers each candidate to a Schedule and executes it on
    the event engine, so queueing on shared resources is priced in and the
    candidate set includes the multi-step library algorithms."""
    from repro_torch.core import schedule as _sched

    results = _sched.search_schedules(
        _spec(machine), nbytes_per_msg, n_msgs,
        peers=peers, split_messages=split_messages,
        include_library=include_library, capacity_overrides=capacity_overrides,
    )
    return _mk_plan({name: r.makespan for name, r in results.items()})


def schedule_search_report(
    machine: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    **kwargs,
) -> Tuple[Plan, Dict[str, "object"]]:
    """(ranked Plan, per-candidate BottleneckReport) for a schedule search."""
    from repro_torch.core import schedule as _sched
    from repro_torch.core.events import bottleneck_report

    results = _sched.search_schedules(_spec(machine), nbytes_per_msg, n_msgs, **kwargs)
    plan = _mk_plan({name: r.makespan for name, r in results.items()})
    return plan, {name: bottleneck_report(r) for name, r in results.items()}


# --------------------------------------------------------------------------
# TPU: cross-pod strategy for mesh collectives (same generic machinery).
# --------------------------------------------------------------------------

def plan_tpu_crosspod(
    topo: TpuPodTopology, bytes_per_chip: float, n_msgs: int = 1
) -> Plan:
    p = simulate.TpuCollectiveProblem(topo=topo, bytes_per_chip=bytes_per_chip, n_msgs=n_msgs)
    return _mk_plan(simulate.tpu_strategy_costs(p))


def plan_tpu_allreduce(topo: TpuPodTopology, bytes_per_chip: float) -> Plan:
    """Gradient all-reduce: flat ring over all chips (its 2·pods DCN-crossing
    hops priced inside the schedule) vs pod-hierarchical — both executed on
    the event engine."""
    from repro_torch.core.events import run_schedule
    from repro_torch.core.schedule import flat_ring_allreduce_schedule

    flat = run_schedule(
        flat_ring_allreduce_schedule(topo, bytes_per_chip)
    ).makespan
    hier = simulate.hierarchical_allreduce_time(topo, bytes_per_chip)
    return _mk_plan({"flat_ring": flat, "pod_hierarchical": hier})


def plan_ep_dispatch(
    topo: TpuPodTopology,
    bytes_per_bucket: float,
    group_sizes: Tuple[int, int],
) -> Plan:
    """Direct vs two-hop hierarchical all-to-all over a 2-axis EP group
    (serving layout): direct sends P-1 messages per rank; two-hop sends
    (inner-1) + (outer-1) messages, each hop moving the full payload once —
    the paper's message-count-vs-volume trade (§V/§VI) at decode payload
    sizes, expressed as ICI-tier schedules run on the event engine."""
    from repro_torch.core.events import run_schedule
    from repro_torch.core.schedule import ep_dispatch_schedules

    scheds = ep_dispatch_schedules(machine_for(topo), bytes_per_bucket, group_sizes)
    return _mk_plan({k: run_schedule(s).makespan for k, s in scheds.items()})


def plan_moe_alltoall(
    topo: TpuPodTopology,
    tokens_per_chip: int,
    d_model: int,
    n_experts: int,
    top_k: int,
    bytes_per_elt: int = 2,
    expert_axis: str = "model",
    crosses_pod: bool = False,
) -> Plan:
    """Expert-parallel dispatch all-to-all — the paper's Alltoall case study
    on the TPU target.  Payload per chip = tokens * top_k * d_model bytes,
    spread over n_experts peer buckets (n_msgs ~ experts)."""
    payload = tokens_per_chip * top_k * d_model * bytes_per_elt
    if not crosses_pod:
        # intra-pod: direct a2a over ICI (per-expert messages queueing on the
        # chip's links, paying the real torus ring distance) vs tree — both
        # lowered to schedules and executed on the event engine.
        from repro_torch.core.events import run_schedule
        from repro_torch.core.schedule import moe_alltoall_schedules

        scheds = moe_alltoall_schedules(topo, payload, n_experts)
        return _mk_plan({k: run_schedule(s).makespan for k, s in scheds.items()})
    return plan_tpu_crosspod(topo, payload, n_msgs=n_experts)

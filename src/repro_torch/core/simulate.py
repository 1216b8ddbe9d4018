"""Collective strategy cost simulation — paper §VI (Fig 6), machine-agnostic.

A strategy is a declared entry in a machine's :class:`MachineSpec` — a path
(tier composition) plus its lane count — so simulating "every way to run
this collective on this machine" is one generic loop over
``spec.strategies``, evaluated by :func:`repro_torch.core.machine.strategy_time`.

The GPU family declares the paper's four Alltoall lowerings:

1. ``cuda_aware`` — each GPU direct-sends G-1 messages of s.
2. ``three_step`` — D2H copy of (G-1)*s, single CPU core per GPU sends G-1
                    messages, H2D copy on the receiver.
3. ``extra_msg``  — D2H to one core, redistribute across the per-GPU core
                    group (the "extra messages"), each core runs the
                    collective on s/c-sized pieces; gather back; H2D.
4. ``dup_devptr`` — each core copies its own slice (copy-engine launch
                    latency serializes), each core sends its share.

The TPU family declares ``direct`` / ``staged`` / ``multirail``.

For MPI_Alltoall the per-core *message count stays G-1* (paper: "utilizing
all CPU cores does not reduce the number of messages per process"); for the
point-to-point MPI_Alltoallv pattern (``split_messages=True``) it drops to
(G-1)/c on the strategies whose traversals allow the split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.machine import MachineSpec, machine_for, simulate_strategies, strategy_time
from repro_torch.core.topology import GpuNodeTopology, TpuPodTopology


@dataclasses.dataclass(frozen=True)
class CollectiveProblem:
    topo: GpuNodeTopology
    nodes: int
    msg_bytes: float  # per-pair message size s
    split_messages: bool = False  # Alltoallv point-to-point: msgs split over cores

    @property
    def n_gpus(self) -> int:
        return self.nodes * self.topo.gpus_per_node

    @property
    def n_msgs(self) -> int:
        return self.n_gpus - 1

    @property
    def spec(self) -> MachineSpec:
        return machine_for(self.topo)


def _t(x) -> float:
    return float(np.asarray(x, np.float64))


def strategy_cost(p: CollectiveProblem, strategy: str) -> float:
    """One declared strategy's cost for this collective problem."""
    return _t(
        strategy_time(
            p.spec, strategy, p.msg_bytes, p.n_msgs,
            concurrency=p.topo.gpus_per_node, split_messages=p.split_messages,
        )
    )


def simulate_all(p: CollectiveProblem) -> Dict[str, float]:
    """Every strategy the machine declares — the generic §VI simulator."""
    return simulate_strategies(
        p.spec, p.msg_bytes, p.n_msgs,
        concurrency=p.topo.gpus_per_node, split_messages=p.split_messages,
    )


def best_strategy(p: CollectiveProblem) -> str:
    costs = simulate_all(p)
    return min(costs, key=costs.get)


# Named helpers kept for direct use in notebooks/benchmarks.
def cuda_aware_time(p: CollectiveProblem) -> float:
    return strategy_cost(p, "cuda_aware")


def three_step_collective_time(p: CollectiveProblem) -> float:
    return strategy_cost(p, "three_step")


def extra_msg_time(p: CollectiveProblem) -> float:
    return strategy_cost(p, "extra_msg")


def dup_devptr_time(p: CollectiveProblem) -> float:
    return strategy_cost(p, "dup_devptr")


# --------------------------------------------------------------------------
# TPU cross-pod collective strategies (same generic simulator, TPU spec).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuCollectiveProblem:
    topo: TpuPodTopology
    bytes_per_chip: float  # payload each chip contributes
    n_msgs: int = 1  # logical messages per chip (e.g. experts, peers)

    @property
    def spec(self) -> MachineSpec:
        return machine_for(self.topo)


def tpu_strategy_costs(p: TpuCollectiveProblem) -> Dict[str, float]:
    return simulate_strategies(p.spec, p.bytes_per_chip, p.n_msgs)


def tpu_best_strategy(p: TpuCollectiveProblem) -> str:
    costs = tpu_strategy_costs(p)
    return min(costs, key=costs.get)


# --------------------------------------------------------------------------
# Mesh-collective costs (used for roofline napkin math): ring and
# hierarchical algorithms on the TPU torus, expressed as declared schedules
# executed by the event engine (repro_torch.core.schedule / repro_torch.core.events).
# --------------------------------------------------------------------------

def ring_allreduce_time(topo: TpuPodTopology, bytes_per_chip: float, axis_size: int) -> float:
    """Bidirectional-ring all-reduce over an ICI axis: 2(k-1) rounds moving
    S/k per link split over both directions (2(k-1)/k · S total), as a ring
    Schedule on the ICI tier run by the event engine."""
    from repro_torch.core.events import run_schedule
    from repro_torch.core.schedule import ring_allreduce_schedule

    sched = ring_allreduce_schedule(
        machine_for(topo), "ici", axis_size, bytes_per_chip
    )
    return run_schedule(sched).makespan


def hierarchical_allreduce_time(topo: TpuPodTopology, bytes_per_chip: float) -> float:
    """Pod-aware: reduce-scatter in pod, cross-pod ring all-reduce of the
    1/chips shards over DCN (all hosts inject), all-gather in pod — a
    chained schedule composition executed by the event engine
    (:func:`repro_torch.core.schedule.hierarchical_allreduce_schedule`)."""
    from repro_torch.core.events import run_schedule
    from repro_torch.core.schedule import hierarchical_allreduce_schedule

    sched = hierarchical_allreduce_schedule(topo, bytes_per_chip)
    return run_schedule(sched).makespan

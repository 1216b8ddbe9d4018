"""Model-guided strategy selection for the mesh collectives.

This is where ``repro_torch.core`` (the paper) meets ``repro_torch.comms`` (the
framework): given the mesh shape and payload, consult the performance models
and return the strategy string the collective wrappers accept.  Selection is
machine-agnostic — every entry point takes a registry name (or a
:class:`~repro_torch.core.machine.MachineSpec`, e.g. one fitted live by
:func:`repro_torch.core.benchmark.spec_from_measurements`), defaulting to the
deployment target.  An optional measured-autotune path benchmarks the
candidates live and records which one the model would have picked
(model-vs-measurement is the paper's validation loop).

A copy of ``repro.comms.autotune``.  The collective wrappers it names
(``comms.allreduce``, ``comms.alltoall``) are not ported yet; the serve loop
consults :func:`select_allreduce_strategy` every decode step.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.machine import (
    MachineSpec,
    machine_for,
    plan_costs,
    registry_generation,
    resolve_spec,
    simulate_strategies,
)
from repro_torch.core.params import Locality
from repro_torch.core.planner import (
    Plan,
    plan_ep_dispatch,
    plan_schedule_search,
    plan_tpu_allreduce,
    plan_tpu_crosspod,
)
from repro_torch.core.topology import TpuPodTopology
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import observed

# Registry name of the machine this deployment runs on; selectors use it
# when no machine is given.  Point it at a fitted spec to let live
# measurements drive every subsequent planning decision.  The mesh-shaped
# selectors additionally require the machine to declare the TPU path family
# (direct/staged/multirail); others fall back to the deployment default.
_DEFAULT_MACHINE = "tpu_v5e"
_ACTIVE_MACHINE: str = _DEFAULT_MACHINE

_log = logging.getLogger(__name__)


def set_active_machine(name: str) -> str:
    """Switch the default machine the selectors consult (returns the old).

    Also drops the plan cache: cached decisions may have been resolved
    against the previous default."""
    global _ACTIVE_MACHINE
    old, _ACTIVE_MACHINE = _ACTIVE_MACHINE, name
    clear_plan_cache()
    return old


def active_machine() -> str:
    return _ACTIVE_MACHINE


# --------------------------------------------------------------------------
# Plan cache: memoized select_* decisions for the hot path.
#
# Selection is deterministic given (machine structure, problem shape), so
# the wrappers in comms.allreduce / comms.alltoall and the serving loop can
# afford a model consultation *per collective call*: a warm lookup is a dict
# probe instead of a full lower-and-simulate pass.
#
# Keys quantize payload size to log2 buckets (_BUCKETS_PER_OCTAVE per
# doubling): two sizes in one bucket differ by at most a factor of
# 2**(1/8) ~ 1.09, and postal-model costs satisfy T(lambda*s) <= lambda*T(s)
# for lambda >= 1 (alpha is size-independent), so a cached pick is within
# 2**(2/8) ~ 1.19x of optimal for any size sharing the bucket — well inside
# the margin separating the models' crossovers (DESIGN.md §7).  Exact sizes
# whose buckets differ never share an entry, so a sweep of distinct octaves
# (the reference's pick-parity gate, benchmarks/planner_speed.py) sees zero
# drift.
#
# Invalidation: every key embeds the resolved MachineSpec.fingerprint (and
# the mesh topology for the mesh-shaped selectors); additionally the whole
# cache is dropped when the machine registry generation changes (any
# register_machine call, e.g. re-registering a live refit) or when
# set_active_machine switches the default.
# --------------------------------------------------------------------------

_BUCKETS_PER_OCTAVE = 8
_PLAN_CACHE: "OrderedDict[tuple, str]" = OrderedDict()
_PLAN_CACHE_MAX = 4096
_PLAN_CACHE_GEN = -1
_PLAN_CACHE_HITS = 0
_PLAN_CACHE_MISSES = 0


def clear_plan_cache() -> None:
    """Drop every cached plan decision."""
    global _PLAN_CACHE_HITS, _PLAN_CACHE_MISSES
    _PLAN_CACHE.clear()
    _PLAN_CACHE_HITS = 0
    _PLAN_CACHE_MISSES = 0


def plan_cache_info() -> Dict[str, int]:
    return {
        "entries": len(_PLAN_CACHE),
        "hits": _PLAN_CACHE_HITS,
        "misses": _PLAN_CACHE_MISSES,
        "max_entries": _PLAN_CACHE_MAX,
    }


def _bucket(nbytes: float) -> int:
    """log2 payload bucket: 8 buckets per doubling, sizes <= 1 share one."""
    if nbytes <= 1.0:
        return 0
    return int(round(_BUCKETS_PER_OCTAVE * math.log2(float(nbytes))))


def _plan_cached(key: tuple, compute: Callable[[], str]) -> str:
    global _PLAN_CACHE_GEN, _PLAN_CACHE_HITS, _PLAN_CACHE_MISSES
    gen = registry_generation()
    if gen != _PLAN_CACHE_GEN:
        # a machine was (re-)registered since the cache was filled
        _PLAN_CACHE.clear()
        _PLAN_CACHE_GEN = gen
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        _PLAN_CACHE_HITS += 1
        _PLAN_CACHE.move_to_end(key)
        obs_metrics.inc("plan_cache.hit")
        return hit
    _PLAN_CACHE_MISSES += 1
    obs_metrics.inc("plan_cache.miss")
    val = compute()
    _PLAN_CACHE[key] = val
    if len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return val


def _mesh_topo_key(topo: "TpuPodTopology") -> Tuple[int, int, int]:
    return (topo.pods, topo.torus_x, topo.torus_y)


def _resolve(machine: Union[str, MachineSpec, None]) -> MachineSpec:
    return resolve_spec(machine, default=_ACTIVE_MACHINE)


@observed("plan.select_transfer_path", pick=str)
def select_transfer_path(
    machine: Union[str, MachineSpec, None],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    locality: Locality = Locality.OFF_NODE,
) -> str:
    """Best declared path variant for a message batch on ANY registered
    machine — the §V decision (GPUDirect vs 3-step / direct vs staged),
    driven purely by the machine's spec."""
    spec = _resolve(machine)
    key = ("path", spec.fingerprint, _bucket(nbytes_per_msg),
           int(n_msgs), locality.value)

    def compute() -> str:
        costs = plan_costs(spec, nbytes_per_msg, n_msgs, locality=locality)
        return min(costs, key=costs.get)

    return _plan_cached(key, compute)


@observed("plan.select_collective_strategy", pick=str)
def select_collective_strategy(
    machine: Union[str, MachineSpec, None],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    split_messages: bool = False,
) -> str:
    """Best declared collective strategy (the §VI decision) for ANY
    registered machine, including live-fitted ones."""
    spec = _resolve(machine)
    key = ("collective", spec.fingerprint, _bucket(nbytes_per_msg),
           int(n_msgs), split_messages)

    def compute() -> str:
        costs = simulate_strategies(
            spec, nbytes_per_msg, n_msgs, split_messages=split_messages
        )
        return min(costs, key=costs.get)

    return _plan_cached(key, compute)


@observed("plan.select_schedule", pick=str)
def select_schedule(
    machine: Union[str, MachineSpec, None],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    split_messages: bool = False,
    peers: Optional[int] = None,
) -> str:
    """Best *simulated* schedule — the event-engine search mode.

    Ranks every declared strategy plus the schedule-library algorithms
    (Bruck, node-aware two-level, ...) by simulated makespan, so multi-step
    schedules the closed forms cannot express compete on equal footing.
    Names are ``strategy:<declared>`` or a library schedule name."""
    spec = _resolve(machine)
    if peers is None and "n_gpus" in spec.facts:
        # elastic/derived specs (core.machine.shrink_spec) record the
        # surviving participant count as a fact; defaulting peers to it
        # means a re-registered shrunk spec is re-planned at the mesh size
        # that actually survives, not at the caller's stale default
        peers = int(spec.facts["n_gpus"])
    key = ("schedule", spec.fingerprint, _bucket(nbytes_per_msg),
           int(n_msgs), split_messages, peers)

    def compute() -> str:
        plan = plan_schedule_search(
            spec, nbytes_per_msg, n_msgs,
            peers=peers, split_messages=split_messages,
        )
        return plan.strategy

    return _plan_cached(key, compute)


@observed("simulate.explain_bottleneck")
def explain_bottleneck(
    machine: Union[str, MachineSpec, None],
    nbytes_per_msg: float,
    n_msgs: int = 1,
    strategy: Optional[str] = None,
    split_messages: bool = False,
):
    """Bottleneck attribution for one schedule (default: the declared best).

    ``strategy`` accepts anything :func:`select_schedule` returns — a
    declared strategy (bare or ``strategy:``-prefixed) or a schedule-library
    name like ``bruck_alltoall``.  Returns a
    :class:`repro_torch.core.events.BottleneckReport` naming the saturated
    resource (link / copy engine / core pool) and the binding term
    (latency / bandwidth / injection) — the paper's "pinpoint the
    communication bottleneck" promise, made executable."""
    from repro_torch.core.events import bottleneck_report, run_schedule
    from repro_torch.core.schedule import candidate_schedules, simulate_schedule

    spec = _resolve(machine)
    if strategy is None:
        strategy = select_collective_strategy(
            spec, nbytes_per_msg, n_msgs, split_messages=split_messages
        )
    bare = strategy.split(":", 1)[1] if strategy.startswith("strategy:") else strategy
    if bare in spec.strategies:
        result = simulate_schedule(
            spec, bare, nbytes_per_msg, n_msgs, split_messages=split_messages
        )
        return bottleneck_report(result)
    cands = candidate_schedules(
        spec, nbytes_per_msg, n_msgs, split_messages=split_messages
    )
    if strategy not in cands:
        raise KeyError(
            f"unknown schedule {strategy!r} for machine {spec.name!r}; "
            f"candidates: {sorted(cands)}"
        )
    return bottleneck_report(run_schedule(cands[strategy]))


def _topo_from_mesh_shape(
    mesh_shape: Dict[str, int], machine: Optional[str] = None
) -> TpuPodTopology:
    pods = mesh_shape.get("pod", 1)
    inner = 1
    for name, size in mesh_shape.items():
        if name != "pod":
            inner *= size
    # squarest torus factorization of the per-pod chip count
    x = int(np.floor(np.sqrt(inner)))
    while inner % x:
        x -= 1
    topo = TpuPodTopology(
        pods=pods, torus_x=x, torus_y=inner // x,
        machine=machine or _ACTIVE_MACHINE,
    )
    if "direct" not in machine_for(topo).paths:
        # the named machine is not a TPU-family spec (e.g. a fitted GPU-style
        # machine set as active): mesh-shaped planning needs the pod paths,
        # so fall back to the deployment default.
        topo = dataclasses.replace(topo, machine=_DEFAULT_MACHINE)
    return topo


# Schedule-search winners -> repro_torch.comms wrapper strategies.  The search
# names either a declared path strategy or a library schedule; a winner with
# no wrapper equivalent (e.g. Bruck) means the event engine preferred an
# algorithm the wrappers don't implement — the closed-form plan decides then.
#
# For the all-reduce the search prices the cross-pod SHARD exchange (the
# hierarchical schedule's middle phase): a staging variant winning it is
# evidence pod-staging pays, but "direct" winning only says which DCN path
# that exchange should use — it does NOT rate flat-vs-hierarchical, so it
# is deliberately unmapped and defers to plan_tpu_allreduce's full
# schedule-vs-schedule comparison.
_SCHEDULE_TO_ALLREDUCE = {
    "strategy:staged": "hierarchical",
    "strategy:multirail": "hierarchical",
}
_SCHEDULE_TO_ALLTOALL = {
    "strategy:direct": "direct",
    "strategy:staged": "hierarchical",
    "strategy:multirail": "hierarchical",
    "node_aware_alltoall": "hierarchical",
}


def _schedule_pick(
    mapping: Dict[str, str], topo: TpuPodTopology, nbytes: float, n_msgs: int
) -> Optional[str]:
    """Consult the event-engine schedule search for a wrapper strategy.

    Returns None when the search cannot decide (winner has no wrapper
    equivalent, or the machine cannot lower the candidates) — callers fall
    back to the closed-form planners.
    """
    try:
        pick = select_schedule(
            machine_for(topo), nbytes, max(int(n_msgs), 1)
        )
    except (KeyError, ValueError) as exc:
        # the expected lowering failures: a machine without the candidate's
        # tiers/paths/facts (KeyError) or an unlowerable problem shape
        # (ValueError).  Anything else is an engine bug and must propagate —
        # a blanket except here silently downgraded every auto-selection to
        # the closed-form fallback.
        _log.debug(
            "schedule search failed on machine %r (nbytes=%s, n_msgs=%s): %s",
            topo.machine, nbytes, n_msgs, exc,
        )
        return None
    return mapping.get(pick)


@observed("plan.select_allreduce_strategy", pick=str)
def select_allreduce_strategy(
    mesh_shape: Dict[str, int], bytes_per_chip: float, machine: Optional[str] = None
) -> str:
    """flat vs hierarchical gradient all-reduce, from the models.

    Consults :func:`select_schedule` first (the event-engine search over the
    cross-pod shard exchange — ``set_active_machine``-aware via the mesh
    topology resolution), then falls back to the closed-form
    :func:`~repro_torch.core.planner.plan_tpu_allreduce` ranking.
    """
    topo = _topo_from_mesh_shape(mesh_shape, machine)
    if topo.pods == 1:
        return "flat"  # no slow tier to stage around
    key = ("allreduce", machine_for(topo).fingerprint, _mesh_topo_key(topo),
           _bucket(bytes_per_chip))

    def compute() -> str:
        shard = bytes_per_chip / max(topo.chips_per_pod, 1)
        pick = _schedule_pick(_SCHEDULE_TO_ALLREDUCE, topo, shard, topo.pods - 1)
        if pick is not None:
            return pick
        plan = plan_tpu_allreduce(topo, bytes_per_chip)
        return {"flat_ring": "flat", "pod_hierarchical": "hierarchical"}[plan.strategy]

    return _plan_cached(key, compute)


@observed("plan.select_alltoall_strategy", pick=str)
def select_alltoall_strategy(
    mesh_shape: Dict[str, int],
    bytes_per_chip: float,
    n_msgs: int = 1,
    crosses_pod: bool = False,
    machine: Optional[str] = None,
) -> str:
    """direct vs hierarchical all-to-all (MoE dispatch), from the models.

    Like :func:`select_allreduce_strategy`: the event-engine schedule search
    decides when its winner maps onto a wrapper strategy; otherwise the
    closed-form cross-pod plan does.
    """
    if not crosses_pod or mesh_shape.get("pod", 1) == 1:
        return "direct"
    topo = _topo_from_mesh_shape(mesh_shape, machine)
    key = ("alltoall", machine_for(topo).fingerprint, _mesh_topo_key(topo),
           _bucket(bytes_per_chip), int(n_msgs))

    def compute() -> str:
        pick = _schedule_pick(_SCHEDULE_TO_ALLTOALL, topo, bytes_per_chip, n_msgs)
        if pick is not None:
            return pick
        plan = plan_tpu_crosspod(topo, bytes_per_chip, n_msgs=n_msgs)
        return {
            "direct": "direct", "staged": "hierarchical",
            "multirail": "hierarchical",
        }[plan.strategy]

    return _plan_cached(key, compute)


@observed("plan.select_moe_dispatch_strategy", pick=str)
def select_moe_dispatch_strategy(
    mesh_shape: Dict[str, int],
    ep_axes,
    bytes_per_bucket: float,
    machine: Optional[str] = None,
) -> str:
    """direct vs hierarchical two-hop dispatch for the MoE a2a, from the
    postal models.  Single-axis EP is always direct; 2-axis groups follow
    plan_ep_dispatch (decode payloads -> hierarchical, the paper's
    small-message staging)."""
    if len(ep_axes) < 2:
        return "direct"
    topo = _topo_from_mesh_shape(mesh_shape, machine)
    sizes = tuple(mesh_shape[a] for a in ep_axes)
    plan = plan_ep_dispatch(topo, bytes_per_bucket, sizes)  # type: ignore[arg-type]
    return plan.strategy


@dataclasses.dataclass
class AutotuneRecord:
    strategy: str
    measured: Dict[str, float]
    model_pick: str
    agreed: bool


# Timing source for measured_autotune.  time.perf_counter is specified to
# be monotonic, but that property is load-bearing here (a clock stepping
# backwards would turn min-of-reps into garbage), so assert it once at
# import instead of trusting the platform.
_CLOCK = time.perf_counter
assert time.get_clock_info("perf_counter").monotonic, (
    "measured_autotune needs a monotonic timer; perf_counter is not "
    "monotonic on this platform"
)


def measured_autotune(
    candidates: Dict[str, Callable[[], None]],
    model_pick: str,
    reps: int = 5,
    warmup: int = 1,
    *,
    predicted: Optional[Dict[str, float]] = None,
    machine: str = "",
    nbytes: float = 0.0,
    tier: str = "autotune",
) -> AutotuneRecord:
    """Run each candidate, take min-of-reps, pick the fastest; record whether
    the model agreed (the paper's model-validation loop, §VI).

    ``warmup`` calls run first and are discarded — they absorb one-time
    costs (JIT compilation, cache population) so ``reps`` measures the
    steady state.  Min-of-reps (not mean) is the right statistic for a
    deterministic operation timed on a noisy host: noise only ever adds.

    When the caller also has model *predictions* for the candidates, pass
    ``predicted={name: seconds}`` (plus ``machine``/``nbytes``/``tier``
    context): every (predicted, measured) pair lands in
    :mod:`repro_torch.obs.drift`, which is how model drift becomes visible
    to the drift summary without any extra timing work.

    Example — timing planner warm-path throughput::

        rec = measured_autotune(
            {"warm": lambda: select_schedule("summit", 4096.0, 8)},
            model_pick="warm", reps=5, warmup=1,
        )
        plans_per_sec = 1.0 / rec.measured["warm"]
    """
    measured: Dict[str, float] = {}
    for name, fn in candidates.items():
        for _ in range(max(warmup, 0)):
            fn()  # discard: compile/JIT/cache-fill
        best = float("inf")
        for _ in range(reps):
            t0 = _CLOCK()
            fn()
            best = min(best, _CLOCK() - t0)
        measured[name] = best
    pick = min(measured, key=measured.get)
    agreed = pick == model_pick
    if predicted:
        mname = machine or _ACTIVE_MACHINE
        for name, pred in predicted.items():
            if name in measured:
                obs_drift.record(
                    mname, tier, name, nbytes, pred, measured[name]
                )
    obs_metrics.inc("autotune.runs")
    obs_metrics.inc("autotune.agreed" if agreed else "autotune.disagreed")
    return AutotuneRecord(
        strategy=pick, measured=measured, model_pick=model_pick, agreed=agreed
    )

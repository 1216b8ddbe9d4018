"""Declarative collective schedules: lowering, algorithm library, search.

A **Schedule** (:class:`repro_torch.core.events.Schedule`) is a DAG of priced
steps — ``send`` / ``copy_d2h`` / ``copy_h2d`` / ``reduce`` / ``stage`` —
whose durations come from the machine's :class:`TransportTier` postal
models and whose resources (NIC lanes, copy engines, CPU core pools) are
finite.  This module provides the three layers on top of the raw engine:

1. :func:`lower_strategy` — the compiler from a :class:`MachineSpec`'s
   declared strategies.  Every PR-1 strategy (cuda_aware / three_step /
   extra_msg / dup_devptr on the GPU family; direct / staged / multirail on
   the TPU family) lowers to a schedule whose *uncontended* simulated time
   reproduces the closed-form :func:`~repro_torch.core.machine.strategy_time` to
   float round-off (tests pin 1e-9 relative).  The lowering is mechanistic:
   the Dup-Devptr copy serialization, for example, is not a formula here
   but L copy steps queueing on a capacity-1 engine resource.

2. A **schedule library** of multi-step collective algorithms the analytic
   layer cannot express: ring, recursive doubling / halving, Bruck, and
   node-aware two-level variants (Lockhart et al. 2022; Namashivayam 2025).

3. :func:`search_schedules` / :func:`best_schedule` — enumerate every
   applicable schedule for a problem, execute each on the event engine, and
   rank by simulated makespan; :func:`repro_torch.core.planner.plan_schedule_search`
   and :mod:`repro_torch.comms.autotune` consume this.

4. :func:`compose_schedules` / :func:`chain_schedules` — merge step DAGs
   onto ONE shared resource pool (namespaced steps, resources merged by
   name), overlapped at start offsets or chained into sequential phases.
   This is how two collectives contending for the same NIC lanes / copy
   engines / core pools are priced, and how the multi-phase TPU lowerings
   (:func:`hierarchical_allreduce_schedule`,
   :func:`flat_ring_allreduce_schedule`, :func:`moe_alltoall_schedules`)
   are assembled (DESIGN.md §6).

``capacity_overrides`` restricts resource capacities below the lane count —
the contention experiments: the engine's time then *dominates* the
optimistic closed form, and :func:`repro_torch.core.events.bottleneck_report`
names the queue.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.events import (
    BottleneckReport,
    Resource,
    Schedule,
    SimResult,
    Step,
    bottleneck_report,
    run_schedule,
)
from repro_torch.core.machine import (
    MachineSpec,
    Path,
    TransportTier,
    resolve_spec,
)
from repro_torch.core.params import Locality
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_COPY_KINDS = ("copy_d2h", "copy_h2d")


def _maybe_verify(sched: Schedule) -> Schedule:
    """Strict-validation seam (repro_torch.analysis.maybe_verify): no-op unless
    strict mode is armed.  Imported lazily — repro_torch.core's package __init__
    imports this module, and repro_torch.analysis imports repro_torch.core.events, so
    a module-level import here would cycle during package init."""
    from repro_torch.analysis import maybe_verify

    return maybe_verify(sched)


# --------------------------------------------------------------------------
# Lowering memoization.
#
# Lowering is pure: a (spec, problem) pair always produces the same step
# DAG, and Schedule/Step/Resource are frozen, so instances can be shared.
# Entries key on MachineSpec.fingerprint (a structural digest), NOT the
# registry name — a live refit via ``spec_from_measurements`` produces a new
# fingerprint and can never collide with the stale spec's entries.  Calls
# passing ``capacity_overrides`` bypass the cache entirely (the overrides
# mapping is caller state, not part of the problem).
# --------------------------------------------------------------------------

_SCHEDULE_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_SCHEDULE_CACHE_MAX = 512
_SCHEDULE_CACHE_HITS = 0
_SCHEDULE_CACHE_MISSES = 0


def clear_schedule_cache() -> None:
    """Drop all memoized lowerings (tests; explicit invalidation)."""
    global _SCHEDULE_CACHE_HITS, _SCHEDULE_CACHE_MISSES
    _SCHEDULE_CACHE.clear()
    _SCHEDULE_CACHE_HITS = 0
    _SCHEDULE_CACHE_MISSES = 0


def schedule_cache_info() -> Dict[str, int]:
    return {
        "entries": len(_SCHEDULE_CACHE),
        "hits": _SCHEDULE_CACHE_HITS,
        "misses": _SCHEDULE_CACHE_MISSES,
        "max_entries": _SCHEDULE_CACHE_MAX,
    }


def _memo_get(key: tuple):
    global _SCHEDULE_CACHE_HITS, _SCHEDULE_CACHE_MISSES
    hit = _SCHEDULE_CACHE.get(key)
    if hit is not None:
        _SCHEDULE_CACHE_HITS += 1
        _SCHEDULE_CACHE.move_to_end(key)
        obs_metrics.inc("lowering_memo.hit")
    else:
        _SCHEDULE_CACHE_MISSES += 1
        obs_metrics.inc("lowering_memo.miss")
    return hit


def _memo_put(key: tuple, value) -> None:
    _SCHEDULE_CACHE[key] = value
    if len(_SCHEDULE_CACHE) > _SCHEDULE_CACHE_MAX:
        _SCHEDULE_CACHE.popitem(last=False)


def _topo_key(topo) -> tuple:
    """Hashable identity of a topology for memo keys (the spec fingerprint
    alone is not enough: pod count and torus shape live on the topology)."""
    return (
        type(topo).__name__,
        getattr(topo, "pods", None),
        getattr(topo, "torus_x", None),
        getattr(topo, "torus_y", None),
        getattr(topo, "hosts_per_pod", None),
    )


class ScheduleBuilder:
    """Accumulates steps/resources; stages are chained by barrier deps."""

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._steps: List[Step] = []
        self._resources: Dict[str, Resource] = {}
        self.frontier: Tuple[str, ...] = ()

    def resource(self, name: str, capacity: int = 1, tier: Optional[str] = None) -> str:
        cur = self._resources.get(name)
        if cur is None or capacity > cur.capacity:
            self._resources[name] = Resource(
                name, capacity, tier=tier if cur is None else (cur.tier or tier)
            )
        return name

    def step(
        self,
        name: str,
        duration: float,
        *,
        resources: Tuple[str, ...] = (),
        deps: Optional[Tuple[str, ...]] = None,
        **meta,
    ) -> str:
        self._steps.append(
            Step(
                name=name, duration=duration, resources=resources,
                deps=self.frontier if deps is None else deps, **meta,
            )
        )
        return name

    def barrier(self, names: Tuple[str, ...]) -> None:
        """End a stage: later steps depend on all of ``names`` (if any)."""
        if names:
            self.frontier = tuple(names)

    def build(
        self, capacity_overrides: Optional[Mapping[str, int]] = None
    ) -> Schedule:
        resources = dict(self._resources)
        for rname, cap in (capacity_overrides or {}).items():
            if rname in resources:
                resources[rname] = Resource(rname, cap, tier=resources[rname].tier)
        return Schedule(
            name=self.name, steps=tuple(self._steps), resources=resources,
            description=self.description,
        )


# --------------------------------------------------------------------------
# The compiler: MachineSpec strategy -> Schedule.
#
# Mirrors repro_torch.core.machine.traversal_time term-for-term so the uncontended
# makespan equals the analytic path cost; the difference is that lanes,
# copies and redistributions become *steps on resources*, so restricting a
# capacity (or sharing resources between schedule instances) models the
# queueing the closed forms cannot.
# --------------------------------------------------------------------------

def _step_kind(tier_base: str) -> str:
    return tier_base if tier_base in _COPY_KINDS else "send"


def lower_path(
    spec: MachineSpec,
    path: Union[str, Path],
    nbytes_per_msg: float,
    n_msgs: float = 1,
    *,
    lanes: int = 1,
    concurrency: int = 1,
    locality: Locality = Locality.OFF_NODE,
    socket: str = "on-socket",
    dedup_factor: float = 1.0,
    split_messages: bool = False,
    capacity_overrides: Optional[Mapping[str, int]] = None,
    name: Optional[str] = None,
) -> Schedule:
    """Lower one declared path to a Schedule (same knobs as ``path_time``)."""
    p = spec.path(path)
    s = float(nbytes_per_msg)
    n = float(n_msgs)
    b = ScheduleBuilder(name or f"{spec.name}:{p.name}", p.description)

    for si, trav in enumerate(p.steps):
        tier = spec.resolve_tier(trav.tier, trav.locality or locality, socket)
        L = int(spec.value(trav.lanes, default=lanes))
        scale = float(spec.value(trav.byte_scale, default=1.0))
        tag = f"s{si}.{trav.tier}"
        new: List[str] = []

        if trav.kind == "msgs":
            s_eff = s / L if L != 1 else s
            if scale != 1.0:
                s_eff = s_eff * scale
            if trav.split_msgs and split_messages:
                n_eff = max(n / L, 1.0)
            else:
                n_eff = n
            ppn = spec.value(trav.ppn, default=L * concurrency)
            alpha, beta, cap = tier.postal_terms(s_eff, ppn)
            if trav.alpha_extra:
                alpha = alpha + trav.alpha_extra
            a_t = alpha * n_eff
            b_t = beta * (n_eff * s_eff)
            # canonical link-pool name: the lowering models ONE representative
            # rank, whose lanes are rank 0's — the same pool the schedule
            # library declares, so cross-family composition merges (§6.1)
            link = b.resource(
                f"{tier.name}.rank0", max(tier.width, L), tier=tier.name
            )
            res = (link,)
            if trav.tier.startswith("cpu"):
                pool_cap = int(spec.fact("cpu_cores_per_node", max(L, 1)))
                res = (link, b.resource("cpu_cores", max(pool_cap, L)))
            for lane in range(L):
                new.append(b.step(
                    f"{tag}.lane{lane}", a_t + b_t, resources=res,
                    kind=_step_kind(trav.tier), alpha_time=a_t, beta_time=b_t,
                    cap_bound=cap, nbytes=n_eff * s_eff, n_msgs=n_eff,
                ))

        elif trav.kind == "bulk":
            total = s * n
            if scale != 1.0:
                total = total * scale
            if trav.dedup:
                total = total * dedup_factor
            if trav.serialize and tier.serialize_alpha and L > 1:
                # L concurrent copies share ONE engine: the engine resource
                # serializes the launches; per-copy bandwidth is its share.
                t0 = float(tier.time(0.0))
                bw = float(tier.time(total)) - t0
                engine = b.resource(f"{tier.name}.engine", 1, tier=tier.name)
                for lane in range(L):
                    new.append(b.step(
                        f"{tag}.copy{lane}", t0 + bw / L, resources=(engine,),
                        kind=_step_kind(trav.tier), alpha_time=t0,
                        beta_time=bw / L, nbytes=total / L, n_msgs=1.0,
                    ))
            else:
                share = total / L if L != 1 else total
                ppn = spec.value(trav.ppn, default=L * concurrency)
                alpha, beta, cap = tier.postal_terms(share, ppn)
                if trav.alpha_extra:
                    alpha = alpha + trav.alpha_extra
                a_t = alpha * 1.0
                b_t = beta * (1.0 * share)
                if tier.serialize_alpha:
                    res = (b.resource(f"{tier.name}.engine", max(1, L),
                                      tier=tier.name),)
                else:
                    res = (b.resource(f"{tier.name}.rank0",
                                      max(tier.width, L), tier=tier.name),)
                for lane in range(L):
                    new.append(b.step(
                        f"{tag}.bulk{lane}", a_t + b_t, resources=res,
                        kind=_step_kind(trav.tier), alpha_time=a_t,
                        beta_time=b_t, cap_bound=cap, nbytes=share, n_msgs=1.0,
                    ))

        elif trav.kind == "redist":
            total = s * n
            if scale != 1.0:
                total = total * scale
            share = total / L
            ppn = spec.value(trav.ppn, default=L * concurrency)
            alpha, beta, cap = tier.postal_terms(share, ppn)
            if trav.alpha_extra:
                alpha = alpha + trav.alpha_extra
            # L-1 scatter/gather messages issued by ONE root core: a
            # capacity-1 resource serializes them (the Extra-Msg staging).
            root = b.resource(f"{tier.name}.root", 1, tier=tier.name)
            for i in range(L - 1):
                new.append(b.step(
                    f"{tag}.redist{i}", alpha + beta * share, resources=(root,),
                    kind="stage", alpha_time=alpha, beta_time=beta * share,
                    cap_bound=cap, nbytes=share, n_msgs=1.0,
                ))

        else:
            raise ValueError(f"unknown traversal kind {trav.kind!r}")

        b.barrier(tuple(new))

    return b.build(capacity_overrides)


def lower_strategy(
    spec: MachineSpec,
    strategy: str,
    nbytes_per_msg: float,
    n_msgs: float = 1,
    *,
    concurrency: Optional[int] = None,
    locality: Locality = Locality.OFF_NODE,
    socket: str = "on-socket",
    dedup_factor: float = 1.0,
    split_messages: bool = False,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Schedule:
    """Lower one declared collective strategy (same knobs as strategy_time)."""
    decl = spec.strategies[strategy]
    conc = int(spec.fact("injectors_per_node", 1)) if concurrency is None else concurrency
    key = None
    if capacity_overrides is None:
        key = ("lower_strategy", spec.fingerprint, strategy,
               float(nbytes_per_msg), float(n_msgs), conc, locality.value,
               socket, float(dedup_factor), split_messages)
        hit = _memo_get(key)
        if hit is not None:
            return hit
    # span only around real lowering work — memo hits above stay span-free
    with obs_trace.span("lower", strategy=strategy, machine=spec.name):
        sched = lower_path(
            spec, decl.path, nbytes_per_msg, n_msgs,
            lanes=int(spec.value(decl.lanes, default=1)), concurrency=conc,
            locality=locality, socket=socket, dedup_factor=dedup_factor,
            split_messages=split_messages,
            capacity_overrides=capacity_overrides,
            name=f"{spec.name}:{strategy}",
        )
    _maybe_verify(sched)
    if key is not None:
        _memo_put(key, sched)
    return sched


def simulate_schedule(
    spec: Union[str, MachineSpec], strategy: str, nbytes_per_msg, n_msgs=1, **kw
) -> SimResult:
    """Lower a declared strategy and execute it on the event engine."""
    spec = resolve_spec(spec)
    return run_schedule(lower_strategy(spec, strategy, nbytes_per_msg, n_msgs, **kw))


# --------------------------------------------------------------------------
# Schedule composition: many schedules, one machine's resources.
#
# The engine already executes any DAG against shared finite resources; what
# it could not express is "these two collectives run on the SAME machine at
# the same time".  compose_schedules merges step DAGs into one schedule:
# step names are namespaced per part, and resources are merged BY NAME — a
# resource two parts both declare (the machine's NIC lanes, copy engines,
# core pools) becomes one shared pool, which is exactly the cross-collective
# queueing the paper's multi-transfer regime needs priced.
#
# Invariants (pinned in tests/test_compose.py):
#   * parts with disjoint resources compose to max(offset_i + makespan_i);
#   * parts sharing a capacity-limited resource can only be slower than
#     that, and bottleneck_report names the shared resource;
#   * permuting part order or step declaration order changes neither the
#     makespan nor the attribution (the engine is deterministic greedy-list).
# --------------------------------------------------------------------------

SchedulePart = Union[Schedule, Tuple[Schedule, float]]


def _part_sinks(sched: Schedule) -> Tuple[str, ...]:
    """Steps no other step of the same schedule depends on (stage exits)."""
    depended = {d for st in sched.steps for d in st.deps}
    return tuple(st.name for st in sched.steps if st.name not in depended)


def compose_schedules(
    spec: Union[str, MachineSpec, None],
    parts: Sequence[SchedulePart],
    *,
    name: Optional[str] = None,
    chain: bool = False,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Schedule:
    """Merge schedules onto one shared resource pool.

    ``parts`` is a sequence of ``Schedule`` or ``(Schedule, start_offset)``
    pairs; an offset is the earliest wall-clock time any of that part's
    steps may start (``Step.release``), so two collectives can be launched
    staggered.  Step names are namespaced ``{part_name}#{i}/{step}``;
    resources are merged by name and must agree on capacity (they describe
    the same physical machine — pass ``capacity_overrides`` to restrict the
    merged pool).

    ``chain=True`` additionally serializes the parts: each part's entry
    steps depend on the previous non-empty part's exit steps — sequential
    phase composition (the hierarchical all-reduce lowering), as opposed to
    the default overlapped composition.

    ``spec`` only brands the composed schedule's name (pass the machine the
    parts were lowered for, or None); the resource pool itself comes from
    the parts.
    """
    norm: List[Tuple[Schedule, float]] = []
    for part in parts:
        if isinstance(part, Schedule):
            norm.append((part, 0.0))
        else:
            sched, offset = part
            norm.append((sched, float(offset)))
            if offset < 0:
                raise ValueError(
                    f"part {sched.name!r}: negative start offset {offset}"
                )

    resources: Dict[str, Resource] = {}
    steps: List[Step] = []
    prev_exits: Tuple[str, ...] = ()
    for i, (sched, offset) in enumerate(norm):
        prefix = f"{sched.name}#{i}/"
        for rname, res in sched.resources.items():
            cur = resources.get(rname)
            if cur is None:
                resources[rname] = res
            elif cur.capacity != res.capacity:
                raise ValueError(
                    f"composed parts disagree on resource {rname!r} capacity "
                    f"({cur.capacity} vs {res.capacity} in {sched.name!r}); "
                    f"shared resources describe one machine — use "
                    f"capacity_overrides to restrict the merged pool"
                )
        for st in sched.steps:
            deps = tuple(prefix + d for d in st.deps)
            if chain and not deps:
                deps = prev_exits
            steps.append(dataclasses.replace(
                st, name=prefix + st.name, deps=deps,
                release=st.release + offset,
            ))
        if chain and sched.steps:
            prev_exits = tuple(prefix + s for s in _part_sinks(sched))

    for rname, cap in (capacity_overrides or {}).items():
        if rname in resources:
            resources[rname] = Resource(rname, cap, tier=resources[rname].tier)

    if name is None:
        brand = "" if spec is None else f"{resolve_spec(spec).name}:"
        mode = "chain" if chain else "compose"
        name = f"{brand}{mode}({'+'.join(s.name for s, _ in norm)})"
    return _maybe_verify(Schedule(
        name=name, steps=tuple(steps), resources=resources,
        description=f"{'chained' if chain else 'overlapped'} composition of "
                    f"{len(norm)} schedules on shared resources",
    ))


def chain_schedules(
    spec: Union[str, MachineSpec, None],
    parts: Sequence[Schedule],
    *,
    name: Optional[str] = None,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Schedule:
    """Sequential phase composition (see :func:`compose_schedules`)."""
    return compose_schedules(
        spec, list(parts), name=name, chain=True,
        capacity_overrides=capacity_overrides,
    )


# --------------------------------------------------------------------------
# Schedule library: multi-step collective algorithms (ring, recursive
# doubling/halving, Bruck, node-aware two-level).  All costs come from the
# machine's tiers; ``ranks`` expands symmetric participants into separate
# resource owners when contention between them should be modeled (the
# default models one representative rank, which by symmetry carries the
# uncontended makespan).
# --------------------------------------------------------------------------

def _round_robin(
    b: ScheduleBuilder,
    spec: MachineSpec,
    tier: TransportTier,
    rounds: List[Tuple[str, float, float]],  # (kind, nbytes, n_msgs) per round
    *,
    ranks: int = 1,
    ppn: float = 1.0,
    alpha_extra: float = 0.0,
    lanes_per_rank: int = 1,
) -> None:
    """Emit ``rounds`` barrier-synchronized rounds for ``ranks`` peers.

    Each rank's steps occupy the per-rank link pool ``{tier}.rank{r}``,
    sized to the tier's full lane width — one shared name and capacity
    across every library schedule on the machine, so
    :func:`compose_schedules` merges the pools and cross-collective
    queueing on the same physical links is priced (restrict with
    ``capacity_overrides`` to force it).
    """
    links = [
        b.resource(f"{tier.name}.rank{r}", max(tier.width, lanes_per_rank),
                   tier=tier.name)
        for r in range(ranks)
    ]
    for i, (kind, nbytes, nm) in enumerate(rounds):
        alpha, beta, cap = tier.postal_terms(nbytes / max(nm, 1.0), ppn)
        if alpha_extra:
            alpha = alpha + alpha_extra
        a_t = alpha * nm
        b_t = beta * nbytes
        new = tuple(
            b.step(
                f"round{i}.rank{r}", a_t + b_t, resources=(links[r],),
                kind=kind, alpha_time=a_t, beta_time=b_t, cap_bound=cap,
                nbytes=nbytes, n_msgs=nm,
            )
            for r in range(ranks)
        )
        b.barrier(new)


def ring_allreduce_schedule(
    spec: Union[str, MachineSpec],
    tier_name: str,
    axis_size: int,
    bytes_per_rank: float,
    *,
    directions: int = 2,
    ranks: int = 1,
    ppn: float = 1.0,
    locality: Locality = Locality.OFF_NODE,
    name: Optional[str] = None,
) -> Schedule:
    """Bidirectional-ring all-reduce: (k-1) reduce-scatter rounds then (k-1)
    all-gather rounds, each moving S/k per link (split over ``directions``)."""
    spec = resolve_spec(spec)
    tier = spec.resolve_tier(tier_name, locality)
    b = ScheduleBuilder(
        name or f"{spec.name}:ring_allreduce[{axis_size}]",
        f"ring all-reduce over {tier_name}, axis {axis_size}",
    )
    if axis_size > 1:
        chunk = bytes_per_rank / axis_size / directions
        rounds = [("reduce", chunk, 1.0)] * (axis_size - 1)
        rounds += [("send", chunk, 1.0)] * (axis_size - 1)
        _round_robin(b, spec, tier, rounds, ranks=ranks, ppn=ppn,
                     lanes_per_rank=directions)
    return b.build()


def ring_reduce_scatter_schedule(
    spec: Union[str, MachineSpec],
    tier_name: str,
    axis_size: int,
    bytes_per_rank: float,
    *,
    directions: int = 2,
    ranks: int = 1,
    ppn: float = 1.0,
    locality: Locality = Locality.OFF_NODE,
    name: Optional[str] = None,
) -> Schedule:
    """(k-1) reduce rounds, each moving S/k per link (split over
    ``directions``) — the first half of the ring all-reduce, ending with
    each rank holding its 1/k reduced shard."""
    spec = resolve_spec(spec)
    tier = spec.resolve_tier(tier_name, locality)
    b = ScheduleBuilder(
        name or f"{spec.name}:ring_reduce_scatter[{axis_size}]",
        f"ring reduce-scatter over {tier_name}, axis {axis_size}",
    )
    if axis_size > 1:
        chunk = bytes_per_rank / axis_size / directions
        rounds = [("reduce", chunk, 1.0)] * (axis_size - 1)
        _round_robin(b, spec, tier, rounds, ranks=ranks, ppn=ppn,
                     lanes_per_rank=directions)
    return b.build()


def ring_allgather_schedule(
    spec: Union[str, MachineSpec],
    tier_name: str,
    axis_size: int,
    bytes_per_rank: float,
    *,
    directions: int = 1,
    ranks: int = 1,
    ppn: float = 1.0,
    locality: Locality = Locality.OFF_NODE,
    name: Optional[str] = None,
) -> Schedule:
    """(k-1) rounds each forwarding one S-sized block around the ring
    (block split over ``directions`` when bidirectional)."""
    spec = resolve_spec(spec)
    tier = spec.resolve_tier(tier_name, locality)
    b = ScheduleBuilder(
        name or f"{spec.name}:ring_allgather[{axis_size}]",
        f"ring all-gather over {tier_name}",
    )
    if axis_size > 1:
        rounds = [("send", bytes_per_rank / directions, 1.0)] * (axis_size - 1)
        _round_robin(b, spec, tier, rounds, ranks=ranks, ppn=ppn,
                     lanes_per_rank=directions)
    return b.build()


def recursive_doubling_allgather_schedule(
    spec: Union[str, MachineSpec],
    tier_name: str,
    axis_size: int,
    bytes_per_rank: float,
    *,
    ranks: int = 1,
    locality: Locality = Locality.OFF_NODE,
) -> Schedule:
    """log2(k) rounds; round i exchanges the 2^i blocks gathered so far.
    Latency-optimal vs the ring's (k-1) rounds; same total bytes."""
    spec = resolve_spec(spec)
    tier = spec.resolve_tier(tier_name, locality)
    n_rounds = max(int(math.ceil(math.log2(axis_size))), 0) if axis_size > 1 else 0
    rounds = []
    gathered = 1.0
    for _ in range(n_rounds):
        block = min(gathered, axis_size - gathered)
        rounds.append(("send", block * bytes_per_rank, 1.0))
        gathered = min(2 * gathered, float(axis_size))
    b = ScheduleBuilder(
        f"{spec.name}:recursive_doubling_allgather[{axis_size}]",
        f"recursive-doubling all-gather over {tier_name}",
    )
    _round_robin(b, spec, tier, rounds, ranks=ranks)
    return b.build()


def recursive_halving_reduce_scatter_schedule(
    spec: Union[str, MachineSpec],
    tier_name: str,
    axis_size: int,
    bytes_per_rank: float,
    *,
    ranks: int = 1,
    locality: Locality = Locality.OFF_NODE,
) -> Schedule:
    """log2(k) rounds; round i exchanges-and-reduces half the live payload."""
    spec = resolve_spec(spec)
    tier = spec.resolve_tier(tier_name, locality)
    n_rounds = max(int(math.ceil(math.log2(axis_size))), 0) if axis_size > 1 else 0
    rounds = []
    live = float(bytes_per_rank)
    for _ in range(n_rounds):
        live = live / 2
        rounds.append(("reduce", live, 1.0))
    b = ScheduleBuilder(
        f"{spec.name}:recursive_halving_reduce_scatter[{axis_size}]",
        f"recursive-halving reduce-scatter over {tier_name}",
    )
    _round_robin(b, spec, tier, rounds, ranks=ranks)
    return b.build()


def bruck_alltoall_schedule(
    spec: Union[str, MachineSpec],
    tier_name: str,
    n_ranks: int,
    msg_bytes: float,
    *,
    ranks: int = 1,
    locality: Locality = Locality.OFF_NODE,
    ppn: float = 1.0,
) -> Schedule:
    """Bruck all-to-all: ceil(log2 P) rounds, each moving ~P/2 blocks in one
    message — trades bandwidth (each byte moves log P times) for latency."""
    spec = resolve_spec(spec)
    tier = spec.resolve_tier(tier_name, locality)
    n_rounds = max(int(math.ceil(math.log2(n_ranks))), 0) if n_ranks > 1 else 0
    blocks = math.ceil(n_ranks / 2)
    rounds = [("send", blocks * msg_bytes, 1.0)] * n_rounds
    b = ScheduleBuilder(
        f"{spec.name}:bruck_alltoall[{n_ranks}]",
        f"Bruck all-to-all over {tier_name}",
    )
    _round_robin(b, spec, tier, rounds, ranks=ranks, ppn=ppn)
    return b.build()


def node_aware_alltoall_schedule(
    spec: Union[str, MachineSpec],
    msg_bytes: float,
    n_ranks: int,
    *,
    intra_tier: str = "cpu_net",
    inter_tier: Optional[str] = None,
    ranks_per_node: Optional[int] = None,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Schedule:
    """Two-level node-aware all-to-all (Lockhart et al. 2022).

    Phase 1: on-node redistribution so each local rank owns the data bound
    for its partner index on every other node (g-1 messages of (N-1)·s).
    Phase 2: each rank sends N-1 *aggregated* inter-node messages of g·s —
    the message-count reduction that makes node-awareness pay.
    Phase 3: mirror on-node redistribution on the receive side.
    """
    spec = resolve_spec(spec)
    g = int(ranks_per_node or spec.fact("gpus_per_node", 1))
    if inter_tier is None:
        inter_tier = spec.path(spec.crossover_paths[0]).steps[0].tier
    n_nodes = max(int(math.ceil((n_ranks) / g)), 1)
    intra = spec.resolve_tier(intra_tier, Locality.ON_NODE)
    inter = spec.resolve_tier(inter_tier, Locality.OFF_NODE)
    b = ScheduleBuilder(
        f"{spec.name}:node_aware_alltoall[{n_ranks}]",
        "two-level node-aware all-to-all (aggregate per destination node)",
    )
    intra_res = b.resource(f"{intra.name}.intra", max(g, 1), tier=intra.name)
    inter_res = b.resource(f"{inter.name}.rank0", max(inter.width, g),
                           tier=inter.name)

    def intra_phase(label: str) -> None:
        nbytes = max(n_nodes - 1, 0) * msg_bytes
        n_eff = float(max(g - 1, 0))
        alpha, beta, cap = intra.postal_terms(nbytes, g)
        a_t, b_t = alpha * n_eff, beta * (n_eff * nbytes)
        b.barrier(tuple(
            b.step(
                f"{label}.rank{r}", a_t + b_t, resources=(intra_res,),
                kind="stage", alpha_time=a_t, beta_time=b_t, cap_bound=cap,
                nbytes=n_eff * nbytes, n_msgs=n_eff,
            )
            for r in range(g)
        ))

    intra_phase("gather")
    nbytes = g * msg_bytes
    n_eff = float(max(n_nodes - 1, 0))
    alpha, beta, cap = inter.postal_terms(nbytes, g)
    a_t, b_t = alpha * n_eff, beta * (n_eff * nbytes)
    b.barrier(tuple(
        b.step(
            f"inter.rank{r}", a_t + b_t, resources=(inter_res,),
            kind="send", alpha_time=a_t, beta_time=b_t, cap_bound=cap,
            nbytes=n_eff * nbytes, n_msgs=n_eff,
        )
        for r in range(g)
    ))
    intra_phase("scatter")
    return b.build(capacity_overrides)


# --------------------------------------------------------------------------
# EP-dispatch schedules (the planner's 2-axis expert-parallel all-to-all,
# formerly bespoke mesh math in planner.plan_ep_dispatch).
# --------------------------------------------------------------------------

def ep_dispatch_schedules(
    spec: Union[str, MachineSpec],
    bytes_per_bucket: float,
    group_sizes: Tuple[int, int],
) -> Dict[str, Schedule]:
    """Direct vs two-hop hierarchical all-to-all over a 2-axis EP group.

    Each phase is one declared hop on the ICI tier: ``direct`` sends P-1
    messages; ``hierarchical`` sends (inner-1) then (outer-1) messages, each
    hop moving the full payload once — the paper's message-count-vs-volume
    trade expressed as schedule steps instead of inline postal arithmetic.
    """
    spec = resolve_spec(spec)
    key = ("ep_dispatch", spec.fingerprint, float(bytes_per_bucket),
           tuple(group_sizes))
    hit = _memo_get(key)
    if hit is not None:
        return dict(hit)
    tier = spec.resolve_tier("ici")
    links = int(spec.fact("ici_links", 1))
    outer, inner = group_sizes
    P_total = outer * inner
    s_total = bytes_per_bucket * P_total

    def hop_schedule(name: str, hops: List[Tuple[str, float]]) -> Schedule:
        b = ScheduleBuilder(f"{spec.name}:ep_{name}", f"EP dispatch ({name})")
        res = b.resource(f"{tier.name}.rank0", links, tier=tier.name)
        for i, (kind, n_eff) in enumerate(hops):
            alpha, beta, _ = tier.postal_terms(s_total / max(n_eff, 1.0), 1)
            a_t = n_eff * alpha
            b_t = s_total * beta / links
            b.barrier((b.step(
                f"hop{i}", a_t + b_t, resources=(res,), kind=kind,
                alpha_time=a_t, beta_time=b_t, nbytes=s_total, n_msgs=n_eff,
            ),))
        return b.build()

    out = {
        "direct": hop_schedule("direct", [("send", float(P_total - 1))]),
        "hierarchical": hop_schedule(
            "hierarchical",
            [("stage", float(inner - 1)), ("send", float(outer - 1))],
        ),
    }
    _memo_put(key, dict(out))
    return out


# --------------------------------------------------------------------------
# TPU collective lowerings (formerly TpuPathModels closed forms in
# simulate.hierarchical_allreduce_time / planner.plan_tpu_allreduce /
# planner.plan_moe_alltoall): every phase is a schedule, phases are chained
# with compose_schedules, and the event engine prices the whole thing.
# --------------------------------------------------------------------------

def hierarchical_allreduce_schedule(
    topo,
    bytes_per_chip: float,
    *,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Schedule:
    """Pod-hierarchical all-reduce as a chained composition of phases:

    1. in-pod ring reduce-scatter over the x then y torus axes, leaving each
       chip with its 1/chips_per_pod reduced shard;
    2. cross-pod ring all-reduce of the shards over DCN — every host injects
       (``ppn = hosts_per_pod``), rounds of shard/pods;
    3. in-pod ring all-gather (y then x) redistributing the now globally-
       reduced shards — the phase the old closed form forgot (it summed two
       *full* in-pod all-reduces and never gathered the cross-pod results;
       the in-pod byte/alpha totals coincide, but the cross-pod exchange is
       now an explicit ring paying per-round DCN latency instead of one
       aggregate message).
    """
    from repro_torch.core.machine import machine_for

    spec = machine_for(topo)
    key = None
    if capacity_overrides is None:
        key = ("hier_allreduce", spec.fingerprint, _topo_key(topo),
               float(bytes_per_chip))
        hit = _memo_get(key)
        if hit is not None:
            return hit
    B = float(bytes_per_chip)
    x, y = topo.torus_x, topo.torus_y
    shard = B / topo.chips_per_pod
    parts: List[Schedule] = [
        ring_reduce_scatter_schedule(
            spec, "ici", x, B, directions=2, name=f"{spec.name}:rs_x[{x}]"),
        ring_reduce_scatter_schedule(
            spec, "ici", y, B / x, directions=2, name=f"{spec.name}:rs_y[{y}]"),
    ]
    if topo.pods > 1:
        parts.append(ring_allreduce_schedule(
            spec, "dcn", topo.pods, shard, directions=1,
            ppn=topo.hosts_per_pod, name=f"{spec.name}:crosspod[{topo.pods}]",
        ))
    parts += [
        ring_allgather_schedule(
            spec, "ici", y, shard, directions=2,
            name=f"{spec.name}:ag_y[{y}]"),
        ring_allgather_schedule(
            spec, "ici", x, B / x, directions=2,
            name=f"{spec.name}:ag_x[{x}]"),
    ]
    sched = compose_schedules(
        spec, parts, chain=True, capacity_overrides=capacity_overrides,
        name=f"{spec.name}:hierarchical_allreduce[{topo.pods}x{x}x{y}]",
    )
    if key is not None:
        _memo_put(key, sched)
    return sched


def flat_ring_allreduce_schedule(
    topo,
    bytes_per_chip: float,
    *,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Schedule:
    """Flat bidirectional ring over ALL chips, pods included: the ICI ring
    schedule chained with the 2·pods ring hops that cross DCN (each carrying
    one S/chips ring chunk at DCN latency/rate, all hosts injecting) —
    formerly an additive ``tpu_direct_time`` penalty in plan_tpu_allreduce."""
    from repro_torch.core.machine import machine_for

    spec = machine_for(topo)
    key = None
    if capacity_overrides is None:
        key = ("flat_allreduce", spec.fingerprint, _topo_key(topo),
               float(bytes_per_chip))
        hit = _memo_get(key)
        if hit is not None:
            return hit
    k = topo.total_chips
    B = float(bytes_per_chip)
    parts: List[Schedule] = [ring_allreduce_schedule(
        spec, "ici", k, B, directions=2, name=f"{spec.name}:flat_ici[{k}]",
    )]
    if topo.pods > 1:
        tier = spec.resolve_tier("dcn")
        chunk = B / k
        b = ScheduleBuilder(
            f"{spec.name}:flat_dcn_hops[{2 * topo.pods}]",
            "ring hops crossing pod boundaries, priced at DCN rate",
        )
        _round_robin(
            b, spec, tier, [("send", chunk, 1.0)] * (2 * topo.pods),
            ppn=topo.hosts_per_pod,
        )
        parts.append(b.build())
    sched = compose_schedules(
        spec, parts, chain=True, capacity_overrides=capacity_overrides,
        name=f"{spec.name}:flat_ring_allreduce[{k}]",
    )
    if key is not None:
        _memo_put(key, sched)
    return sched


def moe_alltoall_schedules(
    topo,
    payload_bytes: float,
    n_experts: int,
    *,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Dict[str, Schedule]:
    """Intra-pod MoE dispatch all-to-all candidates, lowered to ICI schedules.

    ``direct_a2a``: one phase of (E-1) per-expert messages queueing on the
    chip's ICI links; each message crosses the torus at the real ring
    distance of the crossed axes (``x//2 + y//2`` hops — on a 1xN torus the
    x ring is degenerate and the y ring's diameter is what must be paid).

    ``tree_a2a``: ceil(log2 E) barrier-chained rounds of neighbour hops,
    each re-sending half the payload (Bruck-style latency/bandwidth trade).
    """
    from repro_torch.core.machine import machine_for

    spec = machine_for(topo)
    key = None
    if capacity_overrides is None:
        key = ("moe_a2a", spec.fingerprint, _topo_key(topo),
               float(payload_bytes), int(n_experts))
        hit = _memo_get(key)
        if hit is not None:
            return dict(hit)
    tier = spec.resolve_tier("ici")
    links = int(spec.fact("ici_links", 1))
    E = max(int(n_experts), 1)
    s = float(payload_bytes)
    # ring distance of the axes a direct message crosses (torus diameter);
    # a 1xN factorization must price the live axis, not the degenerate one
    hops = max(topo.torus_x // 2 + topo.torus_y // 2, 1)
    hop_alpha = float(spec.fact("ici_hop_alpha", 0.0))

    direct = ScheduleBuilder(
        f"{spec.name}:moe_direct_a2a[{E}]",
        f"direct expert all-to-all: {E - 1} messages at {hops} torus hops",
    )
    # same per-rank link pool name/capacity as the ring library, so
    # compose_schedules merges it with any other ICI schedule's pool
    if E > 1:
        res = direct.resource(f"{tier.name}.rank0", max(tier.width, links),
                              tier=tier.name)
        per_msg = s / (E - 1)
        alpha, beta, cap = tier.postal_terms(per_msg, 1)
        alpha = alpha + hop_alpha * max(hops - 1, 0)
        direct.barrier(tuple(
            direct.step(
                f"peer{i}", alpha + beta * per_msg, resources=(res,),
                kind="send", alpha_time=alpha, beta_time=beta * per_msg,
                cap_bound=cap, nbytes=per_msg, n_msgs=1.0,
            )
            for i in range(E - 1)
        ))

    tree = ScheduleBuilder(
        f"{spec.name}:moe_tree_a2a[{E}]",
        f"tree (Bruck-style) expert all-to-all: log2({E}) neighbour rounds",
    )
    n_rounds = int(math.ceil(math.log2(E))) if E > 1 else 0
    if n_rounds:
        res = tree.resource(f"{tier.name}.rank0", max(tier.width, links),
                            tier=tier.name)
        per_round = s / 2
        alpha, beta, cap = tier.postal_terms(per_round, 1)
        for i in range(n_rounds):
            b_t = beta * per_round / links
            tree.barrier((tree.step(
                f"round{i}", alpha + b_t, resources=(res,),
                kind="send", alpha_time=alpha, beta_time=b_t,
                cap_bound=cap, nbytes=per_round, n_msgs=1.0,
            ),))

    out = {
        "direct_a2a": direct.build(capacity_overrides),
        "tree_a2a": tree.build(capacity_overrides),
    }
    if key is not None:
        _memo_put(key, dict(out))
    return out


# --------------------------------------------------------------------------
# Schedule search: every applicable schedule for a problem, ranked by the
# engine — the planner's new mode beyond the four fixed strategies.
# --------------------------------------------------------------------------

def candidate_schedules(
    spec: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: float = 1,
    *,
    peers: Optional[int] = None,
    split_messages: bool = False,
    concurrency: Optional[int] = None,
    include_library: bool = True,
    capacity_overrides: Optional[Mapping[str, int]] = None,
) -> Dict[str, Schedule]:
    """All schedules implementing "send n messages of s to n peers" here:
    every declared strategy, plus the library algorithms that apply."""
    spec = resolve_spec(spec)
    conc = (
        int(spec.fact("injectors_per_node", 1))
        if concurrency is None else int(concurrency)
    )
    key = None
    if capacity_overrides is None:
        key = ("candidates", spec.fingerprint, float(nbytes_per_msg),
               float(n_msgs), peers, split_messages, conc, include_library)
        hit = _memo_get(key)
        if hit is not None:
            return dict(hit)  # fresh dict: callers may mutate their copy
    cands: Dict[str, Schedule] = {}
    for strat in spec.strategies:
        cands[f"strategy:{strat}"] = lower_strategy(
            spec, strat, nbytes_per_msg, n_msgs,
            concurrency=concurrency, split_messages=split_messages,
            capacity_overrides=capacity_overrides,
        )
    if not include_library:
        if key is not None:
            _memo_put(key, dict(cands))
        return cands
    P = int(peers) if peers is not None else int(n_msgs) + 1
    if P >= 2:
        direct_tier = spec.path(spec.crossover_paths[0]).steps[0].tier
        # same injector count as the declared strategies, so the node
        # injection cap prices every candidate identically
        cands["bruck_alltoall"] = bruck_alltoall_schedule(
            spec, direct_tier, P, nbytes_per_msg, ppn=conc,
        )
        g = int(spec.fact("gpus_per_node", 1))
        if g > 1 and P > g:
            try:
                spec.resolve_tier("cpu_net", Locality.ON_NODE)
            except KeyError:
                pass  # no staging tier (e.g. direct-only fitted machines)
            else:
                cands["node_aware_alltoall"] = node_aware_alltoall_schedule(
                    spec, nbytes_per_msg, P, ranks_per_node=g,
                    capacity_overrides=capacity_overrides,
                )
    for sched in cands.values():
        _maybe_verify(sched)
    if key is not None:
        _memo_put(key, dict(cands))
    return cands


def search_schedules(
    spec: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: float = 1,
    **kwargs,
) -> Dict[str, SimResult]:
    """Execute every candidate schedule; keyed results, unordered."""
    cands = candidate_schedules(resolve_spec(spec), nbytes_per_msg, n_msgs, **kwargs)
    return {name: run_schedule(sched) for name, sched in cands.items()}


def best_schedule(
    spec: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: float = 1,
    **kwargs,
) -> Tuple[str, SimResult]:
    results = search_schedules(spec, nbytes_per_msg, n_msgs, **kwargs)
    name = min(results, key=lambda k: results[k].makespan)
    return name, results[name]


def schedule_bottlenecks(
    spec: Union[str, MachineSpec],
    nbytes_per_msg: float,
    n_msgs: float = 1,
    **kwargs,
) -> Dict[str, BottleneckReport]:
    """Per-candidate bottleneck attribution (saturated resource + binding)."""
    return {
        name: bottleneck_report(res)
        for name, res in search_schedules(spec, nbytes_per_msg, n_msgs, **kwargs).items()
    }

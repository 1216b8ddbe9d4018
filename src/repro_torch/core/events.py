"""Discrete-event execution of collective schedules over shared resources.

The closed-form evaluators (:mod:`repro_torch.core.machine`) price a strategy as a
sum of tier traversals — optimistic by construction, because every lane is
assumed to have its own copy of every resource.  This module executes a
:class:`~repro_torch.core.schedule.Schedule` (a DAG of steps) against *finite*
resources — links with a lane count, per-GPU copy/DMA engines, per-node CPU
core pools — so that concurrent steps queue when they outnumber the slots.
That queueing is exactly what the paper's measured-vs-modeled gaps show
(Fig 6's Dup-Devptr launch serialization, the §IV injection saturation), and
it is what lets :func:`bottleneck_report` *pinpoint* the saturated resource
instead of merely ranking whole strategies.

The engine is a deterministic greedy list scheduler:

* a step becomes *ready* when all its dependencies have finished;
* among ready steps, the one that can start earliest runs next (ties broken
  by declaration order), occupying one slot of each of its resources for its
  whole duration;
* a resource with ``capacity`` slots serializes any excess — the engine
  records which step's completion unblocked each start, giving an exact
  blocking chain for critical-path extraction.

Durations are *inputs* (the schedule builder prices steps with the machine's
``TransportTier`` postal models), so a schedule whose steps never contend
reproduces the analytic cost to float round-off; a schedule whose steps do
contend can only be slower.  ``tests/test_schedule.py`` pins both directions.

Two implementations share those semantics bit-for-bit (DESIGN.md §7):

* :func:`run_schedule` — event-driven: a lazy priority queue of candidate
  (start, declaration-seq) keys with recompute-on-pop, and O(1) per-resource
  free-slot lookups off the holder heaps.  O((V + E + W·log V)) for V steps,
  E dep edges, W queue entries (W is V plus one re-push per key change).
* :func:`run_schedule_reference` — the original quadratic scan (every pick
  re-examines all ready steps and re-sorts holder lists), kept as the
  executable specification; ``tests/test_engine_parity.py`` pins exact
  equality of makespan, per-step start/end/ready, blocker and blocked_on
  on randomized DAGs and every library schedule.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Mapping, Optional, Tuple


# --------------------------------------------------------------------------
# Schedule vocabulary: resources and steps.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Resource:
    """One contended thing: ``capacity`` concurrent slots.

    Examples: a NIC with ``width`` injection lanes, a copy/DMA engine
    (capacity 1 — the §2.2 serialization mechanism), a node's CPU core pool.

    ``tier`` names the physical transport tier this resource is a slice of
    (``"gpu_net:off-node"``, ``"dcn"``); builders populate it so the static
    contention analysis (:mod:`repro_torch.analysis.contention`) can tell that two
    differently-named pools alias the same physical links.  None means
    "unknown" — the analyzer falls back to parsing the canonical
    ``{tier}.rank{r}`` / ``{tier}.engine`` / ``{tier}.root`` naming scheme
    (DESIGN.md §6.1).
    """

    name: str
    capacity: int = 1
    tier: Optional[str] = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"resource {self.name!r}: capacity must be >= 1")


@dataclasses.dataclass(frozen=True)
class Step:
    """One unit of work: a priced operation occupying resources for its span.

    ``kind`` is one of ``send`` / ``copy_d2h`` / ``copy_h2d`` / ``reduce`` /
    ``stage`` (free-form tags are allowed).  ``alpha_time`` / ``beta_time``
    split the duration into its latency and bandwidth parts, and
    ``cap_bound`` marks that the bandwidth rate came from the node-aggregate
    injection cap ``beta_N`` rather than the per-lane transport rate —
    :func:`bottleneck_report` aggregates these to name the binding term.

    ``release`` is the earliest wall-clock time the step may start,
    independent of dependencies — how :func:`repro_torch.core.schedule.
    compose_schedules` places whole schedules at a start offset.  A step is
    ready at ``max(release, latest dep end)``.
    """

    name: str
    duration: float
    resources: Tuple[str, ...] = ()
    deps: Tuple[str, ...] = ()
    kind: str = "send"
    alpha_time: float = 0.0
    beta_time: float = 0.0
    cap_bound: bool = False
    nbytes: float = 0.0
    n_msgs: float = 0.0
    release: float = 0.0

    def __post_init__(self):
        # NaN compares false against everything, so the sign checks alone
        # would wave non-finite prices through into the engine's heaps —
        # check finiteness explicitly (the static verifier re-checks these
        # on schedules built without going through this constructor).
        if self.duration != self.duration or self.duration == float("inf"):
            raise ValueError(f"step {self.name!r}: non-finite duration")
        if self.release != self.release or self.release == float("inf"):
            raise ValueError(f"step {self.name!r}: non-finite release time")
        if self.duration < 0:
            raise ValueError(f"step {self.name!r}: negative duration")
        if self.release < 0:
            raise ValueError(f"step {self.name!r}: negative release time")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A named DAG of steps plus the resources they compete for."""

    name: str
    steps: Tuple[Step, ...]
    resources: Mapping[str, Resource]
    description: str = ""

    def __post_init__(self):
        names = set()
        for st in self.steps:
            if st.name in names:
                raise ValueError(f"duplicate step name {st.name!r}")
            names.add(st.name)
        for st in self.steps:
            for d in st.deps:
                if d not in names:
                    raise ValueError(f"step {st.name!r}: unknown dep {d!r}")
            for r in st.resources:
                if r not in self.resources:
                    raise ValueError(f"step {st.name!r}: unknown resource {r!r}")


# --------------------------------------------------------------------------
# Execution traces.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepTrace:
    """One executed step: when it ran and what its start waited on.

    ``blocker`` names the step whose completion gated this start (the
    latest-finishing dependency, or the step whose slot release on
    ``blocked_on`` let this one in); None for steps that start at t=0.
    ``queue_wait`` is start minus ready time — nonzero only under contention.
    """

    step: Step
    start: float
    end: float
    ready: float
    blocker: Optional[str]
    blocked_on: Optional[str]  # resource name when the wait was a queue

    @property
    def queue_wait(self) -> float:
        return self.start - self.ready


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Engine output: makespan plus the full per-step / per-resource record."""

    schedule: Schedule
    makespan: float
    traces: Mapping[str, StepTrace]

    def critical_path(self) -> List[StepTrace]:
        """Blocking chain ending at the step that defines the makespan.

        On exact ``end`` ties the trace with the larger ``queue_wait`` wins
        (the one that actually sat in a queue carries the attribution);
        step name is only the final, deterministic tie-break — so the
        chain is stable under the ``{part}#{i}/{step}`` renaming that
        :func:`repro_torch.core.schedule.compose_schedules` introduces.
        """
        if not self.traces:
            return []
        last = max(
            self.traces.values(),
            key=lambda t: (t.end, t.queue_wait, t.step.name),
        )
        chain = [last]
        seen = {last.step.name}
        while chain[-1].blocker is not None:
            nxt = self.traces[chain[-1].blocker]
            if nxt.step.name in seen:  # defensive: blocking chains are acyclic
                break
            seen.add(nxt.step.name)
            chain.append(nxt)
        chain.reverse()
        return chain

    def busy_time(self, resource: str) -> float:
        return sum(
            t.end - t.start
            for t in self.traces.values()
            if resource in t.step.resources
        )

    def utilization(self, resource: str) -> float:
        if self.makespan <= 0.0:
            return 0.0
        cap = self.schedule.resources[resource].capacity
        return self.busy_time(resource) / (cap * self.makespan)

    def queue_wait(self, resource: str) -> float:
        """Total time steps sat queued for a slot on this resource."""
        return sum(
            t.queue_wait
            for t in self.traces.values()
            if t.blocked_on == resource
        )


# Observability seam (see repro_torch/obs/__init__.py).  This module never
# imports repro_torch.obs; when metrics or tracing are on, obs installs a sink
# here and run_schedule feeds it every result.  The quiet-path cost is one `is not None` check per run — measured
# (not asserted) in the reference's benchmarks/planner_speed.py.
_OBS_SINK = None
# engine op counts from the most recent _run_schedule_impl call; module
# state (not SimResult fields) so the parity-pinned result shape is
# untouched
_LAST_STATS: Dict[str, int] = {}


def set_obs_sink(fn) -> None:
    """Install (or clear, with None) the run_schedule result sink."""
    global _OBS_SINK
    _OBS_SINK = fn


def run_schedule(schedule: Schedule) -> SimResult:
    """Execute the DAG; feed the result to the obs sink when one is set.

    Semantics live in :func:`_run_schedule_impl`; this wrapper exists so
    the instrumented path and the bare engine can be timed against each
    other.
    """
    result = _run_schedule_impl(schedule)
    if _OBS_SINK is not None:
        _OBS_SINK(result, _LAST_STATS)
    return result


def _run_schedule_impl(schedule: Schedule) -> SimResult:
    """Execute the DAG with greedy earliest-start list scheduling.

    Event-driven implementation: semantically identical to
    :func:`run_schedule_reference` (exact same floats, blockers and
    tie-breaks — pinned by tests/test_engine_parity.py) but near-linear.

    Two structural facts make it work:

    * **Full-heap invariant.**  After every commit's prune-then-push, a
      resource's holder heap has at most ``capacity`` entries: the committed
      step's start is >= the time at which <= capacity-1 holders survive
      (that is what its key said), so the prune pops the rest.  Hence the
      reference's ``slot_release`` — copy all holders, filter, sort — reduces
      to an O(1) peek: the heap root (min by ``(end, name)``, the exact
      reference tie-break) is the next slot release iff the heap is full and
      its root ends after the query time.
    * **Lazy keys with recompute-on-pop.**  Each ready step's earliest
      feasible ``(start, declaration_seq)`` key only *increases* as other
      steps commit — except when a commit's prune pops >= 2 entries from a
      full heap (the reference's capacity quirk: holders with coincident
      ends all vacate at once and waiters' feasible starts jump *down*).
      So the queue pops stale candidates, recomputes against current heap
      state, and commits only on an exact key match; the rare decrease case
      is handled eagerly by re-pushing every waiter of the affected
      resource with its fresh key.
    """
    # integer-indexed mirrors of the schedule (string-dict hashing per dep
    # edge is the dominant constant factor at scale); heap entries keep the
    # step NAME because the reference tie-break on coincident slot releases
    # compares (end, name) tuples lexicographically
    step_list = schedule.steps
    V = len(step_list)
    idx_of = {st.name: i for i, st in enumerate(step_list)}
    res_names = list(schedule.resources)
    ridx_of = {r: i for i, r in enumerate(res_names)}
    caps = [schedule.resources[r].capacity for r in res_names]
    step_res: List[Tuple[int, ...]] = [
        tuple(ridx_of[r] for r in st.resources) for st in step_list
    ]
    dependents: List[List[int]] = [[] for _ in range(V)]
    missing = [0] * V
    for i, st in enumerate(step_list):
        missing[i] = len(st.deps)
        for d in st.deps:
            dependents[idx_of[d]].append(i)

    # per-resource: heap of (end, step_name) for slots currently held
    occupied: List[List[Tuple[float, str]]] = [[] for _ in res_names]
    # ready, uncommitted steps listing each resource (for the decrease case)
    waiters: List[set] = [set() for _ in res_names]
    traces: Dict[str, StepTrace] = {}
    NOT_READY = -1.0
    ready_time = [NOT_READY] * V
    ready_blocker: List[Optional[int]] = [None] * V
    pq: List[Tuple[float, int]] = []  # (start, seq) candidates
    # key of one live queue entry per step (dedup: skip pushes that cannot
    # beat an already-queued candidate); cleared when that entry pops
    best_key: List[Optional[float]] = [None] * V
    committed = [False] * V
    heappush, heappop = heapq.heappush, heapq.heappop
    n_push = n_pop = n_stale = 0  # op counts -> _LAST_STATS

    def earliest(i: int) -> Tuple[float, Optional[str], Optional[int]]:
        """(feasible start, blocking holder, blocked resource index) — the
        first resource in declaration order attaining the max, as the
        reference's strict-greater update rule yields."""
        start, rblocker, ri_blk = ready_time[i], None, None
        for ri in step_res[i]:
            heap = occupied[ri]
            # full-heap invariant: a slot frees at the root's end iff the
            # heap holds `capacity` entries all ending after the query time
            if len(heap) == caps[ri] and heap[0][0] > start:
                start, rblocker, ri_blk = heap[0][0], heap[0][1], ri
        return start, rblocker, ri_blk

    def enqueue(i: int, start: Optional[float] = None) -> None:
        nonlocal n_push
        if start is None:
            start = ready_time[i]
            for ri in step_res[i]:
                heap = occupied[ri]
                if len(heap) == caps[ri] and heap[0][0] > start:
                    start = heap[0][0]
        bk = best_key[i]
        if bk is not None and bk <= start:
            return  # a queued candidate at bk <= start already covers this
        best_key[i] = start
        n_push += 1
        heappush(pq, (start, i))

    for i, st in enumerate(step_list):
        if missing[i] == 0:
            ready_time[i] = st.release
            for ri in step_res[i]:
                waiters[ri].add(i)
            enqueue(i)

    while pq:
        key_start, i = heappop(pq)
        n_pop += 1
        if committed[i]:
            continue  # duplicate candidate of a committed step
        if best_key[i] == key_start:
            best_key[i] = None  # the tracked entry is being consumed
        start, rblocker, ri_blk = earliest(i)
        if start != key_start:
            # stale key (keys are copied floats, never arithmetic, so exact
            # equality is the right staleness test); reinsert and retry
            n_stale += 1
            enqueue(i, start)
            continue
        st = step_list[i]
        end = start + st.duration
        if rblocker is not None:
            blocker, blocked_on = rblocker, res_names[ri_blk]
        else:
            bidx = ready_blocker[i]
            blocker = None if bidx is None else step_list[bidx].name
            blocked_on = None
        traces[st.name] = StepTrace(
            step=st, start=start, end=end, ready=ready_time[i],
            blocker=blocker, blocked_on=blocked_on,
        )
        committed[i] = True
        for ri in step_res[i]:
            waiters[ri].discard(i)
            heap = occupied[ri]
            was_full = len(heap) == caps[ri]
            popped = 0
            while heap and heap[0][0] <= start:
                heappop(heap)
                popped += 1
            heappush(heap, (end, st.name))
            if was_full and popped >= 2:
                # the only transition that can *lower* a waiter's feasible
                # start: a full heap lost >= 2 coincidentally-ending holders
                for w in waiters[ri]:
                    enqueue(w)
        for j in dependents[i]:
            missing[j] -= 1
            prev = ready_time[j]
            if prev == NOT_READY:
                # first dep to finish: the floor is the step's release time
                prev = step_list[j].release
                ready_time[j] = prev
            if end >= prev:
                ready_time[j] = end
                ready_blocker[j] = i
            if missing[j] == 0:
                for ri in step_res[j]:
                    waiters[ri].add(j)
                enqueue(j)

    if len(traces) != V:
        unrun = sorted(st.name for i, st in enumerate(step_list)
                       if not committed[i])
        raise ValueError(
            f"schedule {schedule.name!r} has a dependency cycle; "
            f"unrunnable steps: {unrun[:8]}"
        )
    global _LAST_STATS
    _LAST_STATS = {
        "steps_run": V,
        "pq_pushes": n_push,
        "pq_pops": n_pop,
        "stale_retries": n_stale,
    }
    makespan = max((t.end for t in traces.values()), default=0.0)
    return SimResult(schedule=schedule, makespan=makespan, traces=traces)


def run_schedule_reference(schedule: Schedule) -> SimResult:
    """The original greedy scan — every pick re-examines all ready steps —
    kept verbatim as the executable specification :func:`run_schedule` is
    pinned against (O(V²·R·log R) worst case; use only in tests/benches)."""
    steps = {st.name: st for st in schedule.steps}
    seq = {st.name: i for i, st in enumerate(schedule.steps)}
    dependents: Dict[str, List[str]] = {n: [] for n in steps}
    missing: Dict[str, int] = {}
    for st in schedule.steps:
        missing[st.name] = len(st.deps)
        for d in st.deps:
            dependents[d].append(st.name)

    # per-resource: heap of (end, step_name) for slots currently held
    occupied: Dict[str, List[Tuple[float, str]]] = {
        r: [] for r in schedule.resources
    }
    traces: Dict[str, StepTrace] = {}
    ready_time: Dict[str, float] = {}
    ready_blocker: Dict[str, Optional[str]] = {}
    ready: List[str] = []
    for st in schedule.steps:
        if missing[st.name] == 0:
            ready.append(st.name)
            ready_time[st.name] = st.release
            ready_blocker[st.name] = None

    def slot_release(rname: str, at: float) -> Tuple[float, Optional[str]]:
        """(earliest start on rname for a step ready at `at`, blocking step)."""
        heap = occupied[rname]
        cap = schedule.resources[rname].capacity
        # slots whose holders end at or before `at` are free by then
        live = [(e, n) for e, n in heap if e > at]
        if len(live) < cap:
            return at, None
        # must wait for the (len(live)-cap+1)-th earliest end among holders
        live.sort()
        e, n = live[len(live) - cap]
        return e, n

    while ready:
        # pick the ready step that can start earliest (deterministic)
        best = None
        for name in ready:
            st = steps[name]
            t0 = ready_time[name]
            start, rblocker, rname = t0, None, None
            for r in st.resources:
                avail, blk = slot_release(r, t0)
                if avail > start:
                    start, rblocker, rname = avail, blk, r
            key = (start, seq[name])
            if best is None or key < best[0]:
                best = (key, name, start, rblocker, rname)
        _, name, start, rblocker, rname = best
        ready.remove(name)
        st = steps[name]
        end = start + st.duration
        blocker = rblocker if rblocker is not None else ready_blocker[name]
        traces[name] = StepTrace(
            step=st, start=start, end=end, ready=ready_time[name],
            blocker=blocker, blocked_on=rname if rblocker is not None else None,
        )
        for r in st.resources:
            heap = occupied[r]
            while heap and heap[0][0] <= start:
                heapq.heappop(heap)
            heapq.heappush(heap, (end, name))
        for dep_name in dependents[name]:
            missing[dep_name] -= 1
            prev = ready_time.get(dep_name)
            if prev is None:
                # first dep to finish: the floor is the step's release time
                prev = steps[dep_name].release
                ready_time[dep_name] = prev
                ready_blocker[dep_name] = None
            if end >= prev:
                ready_time[dep_name] = end
                ready_blocker[dep_name] = name
            if missing[dep_name] == 0:
                ready.append(dep_name)

    if len(traces) != len(steps):
        unrun = sorted(set(steps) - set(traces))
        raise ValueError(
            f"schedule {schedule.name!r} has a dependency cycle; "
            f"unrunnable steps: {unrun[:8]}"
        )
    makespan = max((t.end for t in traces.values()), default=0.0)
    return SimResult(schedule=schedule, makespan=makespan, traces=traces)


# --------------------------------------------------------------------------
# Bottleneck attribution.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResourceUsage:
    """Aggregate view of one resource across a run."""

    name: str
    capacity: int
    busy: float          # sum of step durations occupying it
    utilization: float   # busy / (capacity * makespan)
    queue_wait: float    # time steps spent queued for a slot
    critical: float      # occupancy by critical-path steps
    alpha_time: float    # latency part of critical occupancy
    beta_time: float     # bandwidth part of critical occupancy
    cap_beta_time: float  # part of beta_time priced at the beta_N cap


def _attribution_key(u: "ResourceUsage"):
    """Deterministic severity order for bottleneck attribution.

    Primary: critical-path occupancy, then total busy time.  Exact ties
    happen whenever the same steps occupy several resources (a lane plus
    its core pool); they resolve toward the nearest-saturation resource —
    higher utilization (busy per slot), then more queue wait — and name
    is the final total-order tie-break, so the report is invariant under
    resource declaration / ``capacity_overrides`` permutations (pinned by
    tests/test_obs.py).
    """
    return (-u.critical, -u.busy, -u.utilization, -u.queue_wait, u.name)


@dataclasses.dataclass(frozen=True)
class BottleneckReport:
    """Which resource bounds the schedule, and through which term.

    ``binding`` is ``"latency"`` when per-message alpha dominates the
    bottleneck resource's critical-path occupancy (the paper's eager /
    message-count regime), ``"injection"`` when the dominating bandwidth
    time was priced at the node-aggregate cap ``beta_N`` (Table III
    saturation), and ``"bandwidth"`` for per-lane transport-rate bound.
    """

    schedule: str
    makespan: float
    bottleneck: str
    binding: str
    resources: Mapping[str, ResourceUsage]
    critical_steps: Tuple[str, ...]

    def summary(self) -> str:
        lines = [
            f"schedule {self.schedule!r}: makespan {self.makespan:.3e}s — "
            f"bottleneck {self.bottleneck!r} ({self.binding}-bound)"
        ]
        # same key as the bottleneck pick: ties cannot reorder under
        # resource declaration / capacity_overrides permutations
        for u in sorted(self.resources.values(), key=_attribution_key):
            lines.append(
                f"  {u.name:<28} busy={u.busy:.3e}s util={u.utilization:5.1%} "
                f"critical={u.critical:.3e}s queue_wait={u.queue_wait:.3e}s"
            )
        lines.append("  critical path: " + " -> ".join(self.critical_steps))
        return "\n".join(lines)


def bottleneck_report(result: SimResult) -> BottleneckReport:
    """Attribute the makespan: saturated resource + binding cost term.

    Single pass over the traces (each trace contributes to every resource
    it occupies, and its ``queue_wait`` to the one it queued on), instead of
    one O(V) scan per resource — per-resource accumulation order matches the
    old per-resource scans, so the sums are bit-identical.
    """
    chain = result.critical_path()
    critical_names = {t.step.name for t in chain}
    resources = result.schedule.resources
    busy = {r: 0.0 for r in resources}
    qwait = {r: 0.0 for r in resources}
    crit = {r: 0.0 for r in resources}
    alpha_t = {r: 0.0 for r in resources}
    beta_t = {r: 0.0 for r in resources}
    cap_t = {r: 0.0 for r in resources}
    for t in result.traces.values():
        dur = t.end - t.start
        on_chain = t.step.name in critical_names
        for rname in t.step.resources:
            busy[rname] += dur
            if on_chain:
                crit[rname] += dur
                alpha_t[rname] += t.step.alpha_time
                beta_t[rname] += t.step.beta_time
                if t.step.cap_bound:
                    cap_t[rname] += t.step.beta_time
        if t.blocked_on is not None:
            qwait[t.blocked_on] += t.queue_wait
    usages: Dict[str, ResourceUsage] = {}
    for rname, res in resources.items():
        util = (
            busy[rname] / (res.capacity * result.makespan)
            if result.makespan > 0.0 else 0.0
        )
        usages[rname] = ResourceUsage(
            name=rname, capacity=res.capacity, busy=busy[rname],
            utilization=util, queue_wait=qwait[rname],
            critical=crit[rname], alpha_time=alpha_t[rname],
            beta_time=beta_t[rname], cap_beta_time=cap_t[rname],
        )
    if not usages:
        return BottleneckReport(
            schedule=result.schedule.name, makespan=result.makespan,
            bottleneck="(none)", binding="latency", resources={},
            critical_steps=tuple(t.step.name for t in chain),
        )
    # most-critical resource; critical/busy ties (common when the same
    # steps occupy two resources) go to the nearest-saturation one —
    # higher utilization, then more queue wait — and finally to name, so
    # dict insertion order (which follows resource declaration /
    # capacity_overrides ordering) cannot flip the answer
    top = min(usages.values(), key=_attribution_key)
    if top.alpha_time >= top.beta_time:
        binding = "latency"
    elif top.cap_beta_time > top.beta_time / 2:
        binding = "injection"
    else:
        binding = "bandwidth"
    return BottleneckReport(
        schedule=result.schedule.name, makespan=result.makespan,
        bottleneck=top.name, binding=binding, resources=usages,
        critical_steps=tuple(t.step.name for t in chain),
    )

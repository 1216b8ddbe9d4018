"""Chrome ``trace_event`` export: engine timelines + wall-clock spans.

Two timebases share one trace file, separated by pid:

* **pid 0 — wall clock.**  :func:`span` events (``plan`` / ``lower`` /
  ``simulate`` / ``decode.step``), timestamped with ``perf_counter``
  relative to tracer start.  This is the serve path's plan->lower->
  simulate->step storyline.
* **pid 1, 2, ... — simulated time.**  Each recorded
  :class:`~repro_torch.core.events.SimResult` becomes its own process: one
  thread (tid) per *lane* of each :class:`Resource` (a capacity-3 NIC is
  three tracks), steps as ``X`` duration events placed on the lane they
  actually occupied, queue waits as ``b``/``e`` async events, and the
  engine's blocker edges as ``s``/``f`` flow arrows — so the blocking
  chain :func:`SimResult.critical_path` walks is the same chain Perfetto
  draws.

Timestamps are microseconds (the trace_event unit); simulated seconds are
scaled by 1e6.  The export is a plain dict (``{"traceEvents": [...],
"metadata": {...}}``) so it round-trips through ``json`` and loads in
Perfetto / ``chrome://tracing`` unchanged.

This module deliberately imports nothing from ``repro_torch.core`` at module
scope: ``repro_torch.core.events`` feeds results in through the sink
:mod:`repro_torch.obs` installs, and everything here duck-types the SimResult /
StepTrace fields, so there is no import cycle.

A copy of ``repro.obs.trace``.  The port adds one thing: every
:func:`span` is also a ``torch.profiler.record_function`` range of the same
name, so a ``torch.profiler`` trace of a run shows the same phases; with no
profiler running that costs a few microseconds a span.  A span times what
the host enqueued before it closed; the serve loop synchronises the device
where a span must cover device work.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

_US = 1e6  # seconds -> trace_event microseconds

_ACTIVE: Optional["Tracer"] = None
# repro_torch.obs sets this to its refresh hook; called after start()/stop()
_on_state_change: Optional[Callable[[], None]] = None

WALL_PID = 0


class Tracer:
    """Accumulates trace events until :func:`stop` hands them back.

    ``record_schedules`` controls whether engine results streaming through
    the obs sink are auto-recorded; the serve path wants that (one openable
    timeline), tight timing probes may turn it off and record explicitly.
    """

    def __init__(self, name: str = "trace", record_schedules: bool = True):
        self.name = name
        self.record_schedules = record_schedules
        self.events: List[dict] = []
        self.metadata: Dict[str, Any] = {"trace_name": name}
        self.t0 = time.perf_counter()
        self._next_pid = WALL_PID + 1
        self._next_flow_id = 1
        self._span_depth = 0
        self.events.append(_meta(WALL_PID, 0, "process_name", name="wall-clock spans"))

    # -- wall-clock spans ---------------------------------------------------

    def begin_span(self, name: str, **args) -> float:
        self._span_depth += 1
        return time.perf_counter()

    def end_span(self, name: str, t_begin: float, **args) -> None:
        self._span_depth -= 1
        ts = (t_begin - self.t0) * _US
        dur = (time.perf_counter() - t_begin) * _US
        ev = {
            "ph": "X", "pid": WALL_PID, "tid": 0, "name": name,
            "cat": "span", "ts": ts, "dur": dur,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Wall-clock instant marker (``i`` event)."""
        ev = {
            "ph": "i", "pid": WALL_PID, "tid": 0, "name": name, "cat": "mark",
            "ts": (time.perf_counter() - self.t0) * _US, "s": "p",
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- wall-clock intervals (async b/e annotations) ------------------------

    def begin_interval(self, name: str, *, cat: str = "health", **args) -> int:
        """Open a wall-clock annotation interval; returns its id.

        Rendered as a ``b``/``e`` async pair on the wall pid — the health
        monitor uses these to paint degraded windows across the serve
        timeline (a span would require strict nesting; degraded intervals
        overlap plan/decode spans arbitrarily).
        """
        iid = self._next_flow_id
        self._next_flow_id += 1
        ev = {
            "ph": "b", "pid": WALL_PID, "tid": 0, "name": name, "cat": cat,
            "id": iid, "ts": (time.perf_counter() - self.t0) * _US,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)
        return iid

    def end_interval(self, name: str, iid: int, *, cat: str = "health",
                     **args) -> None:
        """Close an interval opened by :meth:`begin_interval`."""
        ev = {
            "ph": "e", "pid": WALL_PID, "tid": 0, "name": name, "cat": cat,
            "id": iid, "ts": (time.perf_counter() - self.t0) * _US,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- simulated-time schedule timelines ----------------------------------

    def record_schedule(self, result, *, include_report: bool = False) -> int:
        """Append one SimResult as its own pid; returns the pid used."""
        pid = self._next_pid
        self._next_pid += 1
        events, meta, nflows = schedule_events(
            result, pid, flow_id0=self._next_flow_id,
            include_report=include_report,
        )
        self._next_flow_id += nflows
        self.events.extend(events)
        self.metadata.setdefault("schedules", {})[
            f"{pid}:{result.schedule.name}"
        ] = meta
        return pid

    # -- export -------------------------------------------------------------

    def to_chrome_json(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "metadata": dict(self.metadata),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_json(), f)
            f.write("\n")


# -- module-level tracer management -----------------------------------------

def start(name: str = "trace", record_schedules: bool = True) -> Tracer:
    """Activate a fresh tracer (replacing any active one)."""
    global _ACTIVE
    _ACTIVE = Tracer(name, record_schedules=record_schedules)
    if _on_state_change is not None:
        _on_state_change()
    return _ACTIVE


def stop() -> Optional[Tracer]:
    """Deactivate and return the tracer (None if none was active)."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    if _on_state_change is not None:
        _on_state_change()
    return t


def active() -> Optional[Tracer]:
    return _ACTIVE


def is_active() -> bool:
    return _ACTIVE is not None


@contextmanager
def span(name: str, **args) -> Iterator[None]:
    """Wall-clock span on the active tracer (none when tracing is off) and
    a profiler range."""
    t = _ACTIVE
    with torch.profiler.record_function(name):
        if t is None:
            yield
            return
        t_begin = t.begin_span(name, **args)
        try:
            yield
        finally:
            t.end_span(name, t_begin, **args)


def record_schedule(result, *, include_report: bool = False) -> Optional[int]:
    """Record a SimResult on the active tracer (None when tracing is off)."""
    t = _ACTIVE
    if t is None:
        return None
    return t.record_schedule(result, include_report=include_report)


def begin_interval(name: str, *, cat: str = "health", **args) -> Optional[int]:
    """Open a wall-clock annotation interval (None when tracing is off)."""
    t = _ACTIVE
    if t is None:
        return None
    return t.begin_interval(name, cat=cat, **args)


def end_interval(name: str, iid: Optional[int], *, cat: str = "health",
                 **args) -> None:
    """Close an interval; no-op when tracing is off or ``iid`` is None."""
    t = _ACTIVE
    if t is None or iid is None:
        return
    t.end_interval(name, iid, cat=cat, **args)


def instant(name: str, **args) -> None:
    """Wall-clock instant marker on the active tracer (no-op when off)."""
    t = _ACTIVE
    if t is None:
        return
    t.instant(name, **args)


# -- SimResult -> trace_event conversion ------------------------------------

def _meta(pid: int, tid: int, kind: str, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": kind,
            "args": {"name": name}}


def _assign_lanes(
    result, ordered=None
) -> Tuple[Dict[str, Tuple[str, int]], List[Tuple[str, int]]]:
    """Place each step on a concrete lane of its first resource.

    The engine models a capacity-C resource as C interchangeable slots; the
    trace needs concrete tracks, so traces are replayed in start order and
    each takes the first lane free at its start (same greedy rule the
    engine's heaps implement, so a lane is never double-booked).  Steps
    with no resources share a single ``(unresourced)`` track.

    Returns ``{step_name: (resource, lane)}`` and the ordered list of
    ``(resource, lane)`` tracks actually used.  ``ordered`` accepts the
    (start, name)-sorted trace list when the caller already built it.
    """
    placement: Dict[str, Tuple[str, int]] = {}
    lane_free: Dict[str, List[float]] = {}  # resource -> per-lane busy-until
    tracks: List[Tuple[str, int]] = []
    seen: set = set()
    if ordered is None:
        ordered = sorted(result.traces.values(),
                         key=lambda t: (t.start, t.step.name))
    for tr in ordered:
        res = tr.step.resources[0] if tr.step.resources else "(unresourced)"
        cap = (result.schedule.resources[res].capacity
               if res in result.schedule.resources else 1)
        free = lane_free.setdefault(res, [])
        lane = None
        for i, busy_until in enumerate(free):
            if busy_until <= tr.start:
                lane = i
                break
        if lane is None:
            lane = len(free)
            free.append(0.0)
            if lane >= cap and tr.step.duration > 0:
                # only coincident zero-duration steps may exceed capacity
                lane = min(range(len(free) - 1), key=lambda i: free[i], default=0)
                free.pop()
        if tr.end > free[lane]:
            free[lane] = tr.end
        placement[tr.step.name] = (res, lane)
        if (res, lane) not in seen:
            seen.add((res, lane))
            tracks.append((res, lane))
    return placement, tracks


def schedule_events(
    result, pid: int, *, flow_id0: int = 1, include_report: bool = False
) -> Tuple[List[dict], Dict[str, Any], int]:
    """(events, per-schedule metadata, flow ids consumed) for one SimResult.

    * one ``X`` duration event per step, on its ``(resource, lane)`` track;
    * one ``b``/``e`` async pair per queued start (``cat="queue_wait"``);
    * one ``s``/``f`` flow pair per blocker edge (``cat="blocked_on:..."``
      when the blocker was a queue, ``cat="dep"`` when a dependency) — the
      exact edges ``critical_path()`` walks;
    * metadata: critical path step names, makespan, and (optionally) the
      full :func:`~repro_torch.core.events.bottleneck_report` attribution.
    """
    ordered = sorted(result.traces.values(),
                     key=lambda t: (t.start, t.step.name))
    placement, tracks = _assign_lanes(result, ordered)
    tid_of = {track: i for i, track in enumerate(tracks)}
    events: List[dict] = [
        _meta(pid, 0, "process_name", name=f"schedule: {result.schedule.name}")
    ]
    for (res, lane), tid in tid_of.items():
        cap = (result.schedule.resources[res].capacity
               if res in result.schedule.resources else 1)
        label = res if cap == 1 else f"{res} [lane {lane}]"
        events.append(_meta(pid, tid, "thread_name", name=label))

    chain = result.critical_path()
    critical = {t.step.name for t in chain}
    flow_id = flow_id0
    append = events.append  # hot loop: one X event (+ flows) per step
    for tr in ordered:
        st = tr.step
        tid = tid_of[placement[st.name]]
        qw = tr.queue_wait  # property: compute once per step
        append({
            "ph": "X", "pid": pid, "tid": tid, "name": st.name,
            "cat": st.kind, "ts": tr.start * _US, "dur": st.duration * _US,
            "args": {
                "kind": st.kind,
                "ready": tr.ready,
                "queue_wait": qw,
                "alpha_time": st.alpha_time,
                "beta_time": st.beta_time,
                "nbytes": st.nbytes,
                "critical": st.name in critical,
                "resources": list(st.resources),
            },
        })
        if qw > 0.0:
            qname = f"queue:{tr.blocked_on or '(dep)'}"
            append({
                "ph": "b", "pid": pid, "tid": tid, "name": qname,
                "cat": "queue_wait", "id": flow_id, "ts": tr.ready * _US,
            })
            append({
                "ph": "e", "pid": pid, "tid": tid, "name": qname,
                "cat": "queue_wait", "id": flow_id, "ts": tr.start * _US,
            })
            flow_id += 1
        if tr.blocker is not None:
            blk = result.traces[tr.blocker]
            cat = ("dep" if tr.blocked_on is None
                   else f"blocked_on:{tr.blocked_on}")
            append({
                "ph": "s", "pid": pid, "tid": tid_of[placement[blk.step.name]],
                "name": "unblocks", "cat": cat, "id": flow_id,
                "ts": blk.end * _US,
            })
            append({
                "ph": "f", "bp": "e", "pid": pid, "tid": tid,
                "name": "unblocks", "cat": cat, "id": flow_id,
                "ts": tr.start * _US,
            })
            flow_id += 1

    meta: Dict[str, Any] = {
        "makespan": result.makespan,
        "n_steps": len(result.traces),
        "critical_path": [t.step.name for t in chain],
        "critical_path_queue_wait": sum(t.queue_wait for t in chain),
    }
    if include_report:
        from repro_torch.core.events import bottleneck_report

        rep = bottleneck_report(result)
        meta["bottleneck"] = report_to_json(rep)
    return events, meta, flow_id - flow_id0


def report_to_json(rep) -> dict:
    """BottleneckReport -> plain JSON (the trace-metadata attribution)."""
    return {
        "schedule": rep.schedule,
        "makespan": rep.makespan,
        "bottleneck": rep.bottleneck,
        "binding": rep.binding,
        "critical_steps": list(rep.critical_steps),
        "resources": {
            name: {
                "capacity": u.capacity,
                "busy": u.busy,
                "utilization": u.utilization,
                "queue_wait": u.queue_wait,
                "critical": u.critical,
                "alpha_time": u.alpha_time,
                "beta_time": u.beta_time,
                "cap_beta_time": u.cap_beta_time,
            }
            for name, u in sorted(rep.resources.items())
        },
    }


def to_chrome_json(result, *, include_report: bool = True) -> dict:
    """Standalone export of one SimResult (no active tracer needed).

    Round-trips through ``json.dumps`` and opens in Perfetto: per-resource
    lane tracks, flow arrows along the engine's blocker chains, and the
    critical-path / bottleneck attribution in ``metadata``.
    """
    events, meta, _ = schedule_events(
        result, pid=1, include_report=include_report
    )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"schedules": {f"1:{result.schedule.name}": meta}},
    }

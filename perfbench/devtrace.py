"""What the traced run reads from ``torch.profiler``: the device's busy time
over the traced window, device time by operation name, idle gaps by what
the host was doing, and the recorded launches of named kernels.

The trace is read from the profiler's raw events
(``prof.profiler.kineto_results.events()``), which avoids building the
profiler's per-event Python objects for the hundreds of thousands of device
operations a window holds.  A device operation is a CUDA event that is not
a user annotation (the harness's phase names mirrored on the device).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

WINDOW = "perfbench.window"  # the host range around the traced window
HOST_IDLE = "host between phases"
SHORT_GAP = "gaps under 20 us"
SHORT_GAP_NS = 20_000


@dataclasses.dataclass
class DeviceTrace:
    window_s: float  # the traced window's length on the host
    busy_s: float  # union of device operations' intervals inside it
    op_seconds: Dict[str, float]  # device seconds by operation name
    op_counts: Dict[str, int]  # recorded launches by operation name
    idle_by_phase: Dict[str, float]  # idle seconds by the host phase around them

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(recorded launches, their device seconds) of the kernels whose
        name holds ``fragment``."""
        names = [n for n in self.op_seconds if fragment in n]
        return sum(self.op_counts[n] for n in names), sum(self.op_seconds[n] for n in names)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:n]

    def top_idle(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.idle_by_phase.items(), key=lambda kv: -kv[1])[:n]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _idle_by_phase(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]
                   ) -> Dict[str, float]:
    """Idle seconds by the host phase that holds each gap's midpoint (the
    phases do not overlap); gaps shorter than ``SHORT_GAP_NS`` are the
    device's own spacing between operations and are summed apart."""
    idle: Dict[str, float] = {}
    host = sorted(host)
    j = 0
    for gs, ge in gaps:  # sorted, disjoint
        if ge - gs < SHORT_GAP_NS:
            name = SHORT_GAP
        else:
            mid = (gs + ge) // 2
            while j + 1 < len(host) and host[j + 1][0] <= mid:
                j += 1
            name = host[j][2] if host and host[j][0] <= mid < host[j][1] else HOST_IDLE
        idle[name] = idle.get(name, 0.0) + (ge - gs) / 1e9
    return idle


@dataclasses.dataclass
class Events:
    """A profile's events as the readers take them, read in one pass."""

    window: Tuple[int, int]  # the WINDOW host range, ns
    phases: List[Tuple[int, int, str]]  # the harness's host phases: start, end, name
    device: List[Tuple[int, int, int, str]]  # device operations: start, end, correlation id, name
    host: List[Tuple[int, int, str, int, bool]]  # other host events kept: start, end,
    # name, correlation id, whether a user annotation


def events(prof, phases, host_prefixes: Tuple[str, ...] = ()) -> Events:
    """The events of ``prof``: its ``WINDOW`` range, the host phases named
    ``phases``, every device operation, and the other host events whose
    names start with one of ``host_prefixes``.  The profile is walked once,
    so that a traced run that reads both the device trace and the
    program's spans pays for one walk over its millions of events."""
    from torch.autograd import DeviceType

    names = set(phases) | {WINDOW}
    window = None
    host_phases: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, int, str]] = []
    host: List[Tuple[int, int, str, int, bool]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = e.device_type()
        if kind == DeviceType.CPU:
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name in names:
                host_phases.append((e.start_ns(), e.end_ns(), name))
            elif host_prefixes and name.startswith(host_prefixes):
                host.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                             e.is_user_annotation()))
        elif kind == DeviceType.CUDA and name not in names and not e.is_user_annotation():
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), e.correlation_id(), name))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} range")
    return Events(window, host_phases, device, host)


def read(prof, phases) -> DeviceTrace:
    """The device trace of ``prof`` inside its ``WINDOW`` host range;
    ``phases`` are the host phase names the harness recorded."""
    return trace(events(prof, phases))


def trace(ev: Events) -> DeviceTrace:
    """The device trace of a profile's events (``events``)."""
    ws, we = ev.window
    device = [(max(s, ws), min(e, we), n) for s, e, _, n in ev.device if e > ws and s < we]
    op_seconds: Dict[str, float] = {}
    op_counts: Dict[str, int] = {}
    for s, e, n in device:
        op_seconds[n] = op_seconds.get(n, 0.0) + (e - s) / 1e9
        op_counts[n] = op_counts.get(n, 0) + 1
    busy = _union([(s, e) for s, e, _ in device])
    edges = [ws] + [t for iv in busy for t in iv] + [we]
    gaps = [(gs, ge) for gs, ge in zip(edges[::2], edges[1::2]) if ge > gs]
    idle = _idle_by_phase(gaps, ev.phases)
    return DeviceTrace(window_s=(we - ws) / 1e9,
                       busy_s=sum(e - s for s, e in busy) / 1e9,
                       op_seconds=op_seconds, op_counts=op_counts,
                       idle_by_phase=idle)

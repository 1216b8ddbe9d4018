"""Chrome ``trace_event`` export of wall-clock spans.

A copy of the part of ``repro.obs.trace`` that the serve loop uses: ``span``
events (``prefill`` / ``decode.step``) on pid 0, timestamped with
``perf_counter`` relative to tracer start, in microseconds.  The export loads
in Perfetto / ``chrome://tracing``.  A span times what the host enqueued
before it closed; the serve loop synchronises the device where a span must
cover device work.  Every span is also a ``torch.profiler.record_function``
range of the same name, so a ``torch.profiler`` trace of the run shows the
same phases; with no profiler running that costs a few microseconds a span.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import torch

_US = 1e6  # seconds -> trace_event microseconds

_ACTIVE: Optional["Tracer"] = None

WALL_PID = 0


class Tracer:
    """Accumulates trace events until :func:`stop` hands them back."""

    def __init__(self, name: str = "trace"):
        self.name = name
        self.events: List[dict] = [
            {"ph": "M", "pid": WALL_PID, "tid": 0, "name": "process_name",
             "args": {"name": "wall-clock spans"}}
        ]
        self.metadata: Dict[str, Any] = {"trace_name": name}
        self.t0 = time.perf_counter()

    def end_span(self, name: str, t_begin: float, **args) -> None:
        ev = {
            "ph": "X", "pid": WALL_PID, "tid": 0, "name": name, "cat": "span",
            "ts": (t_begin - self.t0) * _US,
            "dur": (time.perf_counter() - t_begin) * _US,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

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


def start(name: str = "trace") -> Tracer:
    """Activate a fresh tracer (replacing any active one)."""
    global _ACTIVE
    _ACTIVE = Tracer(name)
    return _ACTIVE


def stop() -> Optional[Tracer]:
    """Deactivate and return the tracer (None if none was active)."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


@contextmanager
def span(name: str, **args) -> Iterator[None]:
    """Wall-clock span on the active tracer (none when tracing is off) and a
    profiler range."""
    t = _ACTIVE
    with torch.profiler.record_function(name):
        if t is None:
            yield
            return
        t_begin = time.perf_counter()
        try:
            yield
        finally:
            t.end_span(name, t_begin, **args)

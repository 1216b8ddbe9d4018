"""Observability for the engine, planner, and serve path.

Three stdlib-only pillars (see DESIGN.md §8):

* :mod:`repro_torch.obs.trace` — Chrome ``trace_event`` export: wall-clock spans
  (plan / lower / simulate / decode.step) plus per-resource-lane timelines
  of every ``run_schedule`` result, one Perfetto-loadable file per run.
* :mod:`repro_torch.obs.metrics` — process-global counters / gauges / histograms
  with a zero-cost disabled mode (cache hit rates, engine heap ops,
  planner latency, schedule-pick distributions).
* :mod:`repro_torch.obs.drift` — (predicted, measured) pairs from
  ``measured_autotune`` / ``spec_from_measurements``, reduced to per-tier
  relative-error summaries (the reference's ``benchmarks/run.py --compare``
  gates them).
* :mod:`repro_torch.obs.health` — the link-health monitor fed by the drift
  ledger; :mod:`repro_torch.obs.congestion` fits its degraded variants.

The instrumented core modules never import this package.  Instead,
``repro_torch.core.events`` exposes ``set_obs_sink``; this module installs the
sink only while metrics are enabled or a tracer is active (the
``_on_state_change`` hooks below), so a quiet process pays one ``is not
None`` check per ``run_schedule`` and nothing else.  Planner entry points
use :func:`observed`, whose disabled path is likewise a single check.
A copy of ``repro.obs``.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional

from repro_torch.obs import drift, metrics, trace
from repro_torch.obs import health  # noqa: E402  (needs drift/metrics/trace bound)

# NOTE: repro_torch.obs.congestion is deliberately NOT imported here — it imports
# the modeling core (core.schedule -> core.events), and core.schedule
# imports this package for trace/metrics.  health and callers pull it in
# lazily.
__all__ = ["drift", "health", "metrics", "trace", "observed", "reset_all"]


def _engine_sink(result, stats: dict) -> None:
    """Fed every SimResult (+ engine op stats) by ``run_schedule``."""
    if metrics._ENABLED:
        metrics.inc("engine.runs")
        for k, v in stats.items():
            metrics.inc(f"engine.{k}", float(v))
    t = trace._ACTIVE
    if t is not None and t.record_schedules:
        t.record_schedule(result)


def _refresh_sink() -> None:
    from repro_torch.core import events

    wanted = metrics._ENABLED or (
        trace._ACTIVE is not None and trace._ACTIVE.record_schedules
    )
    events.set_obs_sink(_engine_sink if wanted else None)


metrics._on_state_change = _refresh_sink
trace._on_state_change = _refresh_sink


def observed(
    name: str, pick: Optional[Callable[[object], Optional[str]]] = None
) -> Callable:
    """Instrument a planner entry point: span + latency + pick counter.

    While both pillars are off the wrapper is one flag check and a tail
    call.  Otherwise each call gets a wall-clock :func:`trace.span`, a
    ``{name}.seconds`` latency histogram sample and a ``{name}.calls``
    counter; ``pick`` (given the return value) labels a
    ``{name}.pick.{label}`` counter so the schedule-pick distribution is
    visible without logging every decision.
    """

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not metrics._ENABLED and trace._ACTIVE is None:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with trace.span(name):
                out = fn(*args, **kwargs)
            if metrics._ENABLED:
                metrics.inc(f"{name}.calls")
                metrics.observe(f"{name}.seconds", time.perf_counter() - t0)
                if pick is not None:
                    label = pick(out)
                    if label is not None:
                        metrics.inc(f"{name}.pick.{label}")
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco


def reset_all() -> None:
    """Back to cold state: metrics off+empty, tracer stopped, drift empty,
    link-health monitor fresh."""
    metrics.disable()
    metrics.reset()
    trace.stop()
    drift.reset()
    health.reset()

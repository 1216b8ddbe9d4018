"""Process-global counters / gauges / histograms with a disabled fast path.

The planner, caches, engine and serve loop are *hot* paths — a metrics
layer they cannot afford is a metrics layer nobody enables.  The contract
here (measured in the reference's ``benchmarks/planner_speed.py``
``tracing_overhead`` section; DESIGN.md §8):

* **disabled** (the default): every entry point is one module-flag check
  and an immediate return — no allocation, no dict probe, no lock;
* **enabled**: a dict probe plus an integer/float update.  Histograms keep
  count/sum/min/max and log2 value buckets, not samples, so memory is O(1)
  per metric no matter how many observations arrive.

Everything lives in one process-global :class:`Registry` because the
instrumented modules (``repro_torch.core.events``, ``repro_torch.comms.autotune``, the
serve loop) have no shared object to thread a registry through — the same
reason the machine registry is global.  ``reset()`` restores a pristine
state (the test fixture calls it).

``enable()`` / ``disable()`` invoke ``_on_state_change`` when set;
:mod:`repro_torch.obs` uses that to install/remove the engine sink in
``repro_torch.core.events`` so a fully-disabled process never even reaches this
module from the engine.  A copy of ``repro.obs.metrics``.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional

_ENABLED = False
# repro_torch.obs sets this to its refresh hook; called after enable()/disable()
_on_state_change: Optional[Callable[[], None]] = None


class Counter:
    """Monotonic count (events, hits, misses)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value (cache sizes, queue depths)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """O(1)-memory distribution: count/sum/min/max + log2 value buckets.

    Bucket key is ``floor(log2(v))`` (clamped to [-40, 40]; v <= 0 lands in
    a single underflow bucket) — coarse, but enough to tell a microsecond
    cache probe from a millisecond lower-and-simulate pass at a glance.
    """

    __slots__ = ("name", "count", "total", "min", "max", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        b = -99 if v <= 0.0 else min(max(int(math.floor(math.log2(v))), -40), 40)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Registry:
    """All live metrics, by kind then name."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Turn collection on (idempotent)."""
    global _ENABLED
    _ENABLED = True
    if _on_state_change is not None:
        _on_state_change()


def disable() -> None:
    """Turn collection off; existing values are kept until :func:`reset`."""
    global _ENABLED
    _ENABLED = False
    if _on_state_change is not None:
        _on_state_change()


def reset() -> None:
    """Drop every metric (does not change the enabled flag)."""
    global _REGISTRY
    _REGISTRY = Registry()


def swap_registry(reg: Optional[Registry] = None) -> Registry:
    """Swap in ``reg`` (a fresh registry when ``None``); return the old one.

    Lets a diagnostic section (the reference's
    ``benchmarks/observability.py`` ``metrics_health``) run against a clean slate and then restore the
    process-cumulative metrics it would otherwise have destroyed.
    """
    global _REGISTRY
    old = _REGISTRY
    _REGISTRY = reg if reg is not None else Registry()
    return old


# -- hot-path entry points (no-ops while disabled) --------------------------

def inc(name: str, n: float = 1.0) -> None:
    if not _ENABLED:
        return
    _REGISTRY.counter(name).inc(n)


def gauge(name: str, v: float) -> None:
    if not _ENABLED:
        return
    _REGISTRY.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    if not _ENABLED:
        return
    _REGISTRY.histogram(name).observe(v)


# -- snapshots ---------------------------------------------------------------

def to_json() -> dict:
    """JSON-serializable snapshot of every metric (stable key order)."""
    r = _REGISTRY
    return {
        "enabled": _ENABLED,
        "counters": {k: c.value for k, c in sorted(r.counters.items())},
        "gauges": {k: g.value for k, g in sorted(r.gauges.items())},
        "histograms": {
            k: {
                "count": h.count,
                "sum": h.total,
                "min": None if h.count == 0 else h.min,
                "max": None if h.count == 0 else h.max,
                "mean": h.mean,
                "log2_buckets": {str(b): n for b, n in sorted(h.buckets.items())},
            }
            for k, h in sorted(r.histograms.items())
        },
    }


def dump() -> str:
    """Human-readable multi-line snapshot."""
    snap = to_json()
    lines = [f"metrics (enabled={snap['enabled']}):"]
    for k, v in snap["counters"].items():
        lines.append(f"  counter   {k:<40} {v:g}")
    for k, v in snap["gauges"].items():
        lines.append(f"  gauge     {k:<40} {v:g}")
    for k, h in snap["histograms"].items():
        lines.append(
            f"  histogram {k:<40} n={h['count']} mean={h['mean']:.3e} "
            f"min={h['min'] if h['min'] is None else format(h['min'], '.3e')} "
            f"max={h['max'] if h['max'] is None else format(h['max'], '.3e')}"
        )
    return "\n".join(lines)


def summary_line(prefixes: Optional[List[str]] = None) -> str:
    """One-line ``k=v`` digest (counters verbatim, histograms as n@mean).

    ``prefixes`` filters to metric names starting with any given prefix —
    the serve loop prints only its own families at exit.
    """

    def keep(name: str) -> bool:
        return prefixes is None or any(name.startswith(p) for p in prefixes)

    parts = [
        f"{k}={c.value:g}"
        for k, c in sorted(_REGISTRY.counters.items()) if keep(k)
    ]
    parts += [
        f"{k}={g.value:g}"
        for k, g in sorted(_REGISTRY.gauges.items()) if keep(k)
    ]
    parts += [
        f"{k}={h.count}@{h.mean:.2e}s"
        for k, h in sorted(_REGISTRY.histograms.items()) if keep(k)
    ]
    return " ".join(parts) if parts else "(no metrics)"


def write(path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_json(), f, indent=2, sort_keys=True)
        f.write("\n")

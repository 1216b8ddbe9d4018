"""Process-global counters / gauges / histograms with a disabled fast path.

A copy of the part of ``repro.obs.metrics`` that the serve loop uses:
disabled (the default), every entry point is one flag check; enabled, a dict
probe plus an update.  Histograms keep count/sum/min/max and log2 buckets,
not samples.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

_ENABLED = False


class Counter:
    """Monotonic count (events, tokens)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """O(1)-memory distribution: count/sum/min/max + log2 value buckets."""

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
        self.min = min(self.min, v)
        self.max = max(self.max, v)
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


def enable() -> None:
    """Turn collection on (idempotent)."""
    global _ENABLED
    _ENABLED = True


def inc(name: str, n: float = 1.0) -> None:
    if _ENABLED:
        _REGISTRY.counter(name).inc(n)


def gauge(name: str, v: float) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    if _ENABLED:
        _REGISTRY.histogram(name).observe(v)


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


def summary_line(prefixes: Optional[List[str]] = None) -> str:
    """One-line ``k=v`` digest (counters verbatim, histograms as n@mean)."""

    def keep(name: str) -> bool:
        return prefixes is None or any(name.startswith(p) for p in prefixes)

    r = _REGISTRY
    parts = [f"{k}={c.value:g}" for k, c in sorted(r.counters.items()) if keep(k)]
    parts += [f"{k}={g.value:g}" for k, g in sorted(r.gauges.items()) if keep(k)]
    parts += [
        f"{k}={h.count}@{h.mean:.2e}s" for k, h in sorted(r.histograms.items()) if keep(k)
    ]
    return " ".join(parts) if parts else "(no metrics)"


def write(path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_json(), f, indent=2, sort_keys=True)
        f.write("\n")

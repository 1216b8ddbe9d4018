"""Model-drift ledger: predicted vs measured transport times, per tier.

The registry's whole value is that ``tier.time(nbytes)`` predicts what a
wire transfer actually costs — and the paper's premise is that the real
cost "varies greatly with machine architecture, job partition, and nearby
jobs".  This module is the check: every code path that *has* both numbers
(``benchmark.spec_from_measurements`` fitting a tier against its own
samples, ``measured_autotune`` timing a candidate the model also priced)
drops a :class:`DriftRecord` here, and :func:`summary` reduces them to
per-transport-tier relative-error statistics that the reference's
``benchmarks/run.py`` exports and ``--compare`` gates.  When the model silently diverges from
measurement, CI sees it — and :mod:`repro_torch.obs.health` subscribes through
:data:`_on_record` to turn sustained divergence into degradation state.

Recording is unconditional (no enable flag): the feeding paths already
paid for a real measurement, so one dataclass append is noise.  The
buffer is bounded so a long-running serve process cannot grow it without
limit; evictions are *counted* (``n_evicted``), because a summary over a
silently-rotated window is not the summary of the run.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional

_MAX_RECORDS = 4096


@dataclass(frozen=True)
class DriftRecord:
    """One (model prediction, live measurement) pair.

    ``tier`` is the transport-tier name (``gpu_net``, ``copy_d2h``, ...);
    ``collective`` is the operation context (``fit:gpu_net`` for fitter
    samples, the candidate label for autotune runs).  Times in seconds.
    """

    machine: str
    tier: str
    collective: str
    nbytes: float
    predicted: float
    measured: float

    @property
    def rel_error(self) -> float:
        """(predicted - measured) / measured; inf when measured == 0."""
        if self.measured == 0.0:
            return math.inf if self.predicted != 0.0 else 0.0
        return (self.predicted - self.measured) / self.measured

    @property
    def log2_nbytes(self) -> int:
        """Message-size regime bucket: floor(log2(nbytes)), <=1 byte -> 0.

        The paper's eager/rendezvous protocol segments drift independently,
        so drift (and health) localization needs the size axis, not just
        the tier.
        """
        if self.nbytes <= 1.0:
            return 0
        return int(math.floor(math.log2(self.nbytes)))


_RECORDS: Deque[DriftRecord] = deque()
_N_EVICTED = 0
# single observer hook (repro_torch.obs.health installs its monitor here); kept a
# plain module global so the record() hot path is one None check
_on_record: Optional[Callable[[DriftRecord], None]] = None


def record(
    machine: str,
    tier: str,
    collective: str,
    nbytes: float,
    predicted: float,
    measured: float,
) -> DriftRecord:
    global _N_EVICTED
    r = DriftRecord(
        machine=str(machine),
        tier=str(tier),
        collective=str(collective),
        nbytes=float(nbytes),
        predicted=float(predicted),
        measured=float(measured),
    )
    if len(_RECORDS) >= _MAX_RECORDS:
        _RECORDS.popleft()
        _N_EVICTED += 1
    _RECORDS.append(r)
    if _on_record is not None:
        _on_record(r)
    return r


def records() -> List[DriftRecord]:
    return list(_RECORDS)


def n_evicted() -> int:
    """Records dropped from the bounded buffer since the last reset."""
    return _N_EVICTED


def reset() -> None:
    global _N_EVICTED
    _RECORDS.clear()
    _N_EVICTED = 0


def summary(tol: float = 0.25) -> dict:
    """Per-tier relative-error reduction over every recorded pair.

    ``tol`` is the |rel_error| threshold for the ``within_tol`` fraction —
    the share of predictions within 25% (default) of measurement.  Keys
    are ``machine/tier`` so a report mixing fitted machines stays legible;
    everything is plain JSON for ``BENCH_paper_models.json``.

    Each tier additionally carries ``by_log2_nbytes``: the same reduction
    per message-size regime (floor(log2) buckets), so a tier whose eager
    segment drifts while its rendezvous segment holds is visible as such.
    ``n_evicted`` counts records the bounded buffer dropped — when it is
    non-zero the summary describes a trailing window, not the whole run.
    """
    by_tier: Dict[str, List[DriftRecord]] = {}
    for r in _RECORDS:
        by_tier.setdefault(f"{r.machine}/{r.tier}", []).append(r)

    def reduce(rs: List[DriftRecord]) -> dict:
        errs = [r.rel_error for r in rs]
        finite = [e for e in errs if math.isfinite(e)]
        return {
            "n": len(rs),
            "mean_rel_error": (sum(finite) / len(finite)) if finite else 0.0,
            "mean_abs_rel_error": (
                sum(abs(e) for e in finite) / len(finite) if finite else 0.0
            ),
            "max_abs_rel_error": max((abs(e) for e in finite), default=0.0),
            "within_tol": sum(1 for e in errs if abs(e) <= tol) / len(rs),
            "bytes_range": [min(r.nbytes for r in rs), max(r.nbytes for r in rs)],
        }

    tiers = {}
    for key in sorted(by_tier):
        rs = by_tier[key]
        by_bucket: Dict[int, List[DriftRecord]] = {}
        for r in rs:
            by_bucket.setdefault(r.log2_nbytes, []).append(r)
        entry = reduce(rs)
        entry["by_log2_nbytes"] = {
            str(b): reduce(by_bucket[b]) for b in sorted(by_bucket)
        }
        tiers[key] = entry
    return {
        "tol": tol,
        "n_records": len(_RECORDS),
        "n_evicted": _N_EVICTED,
        "tiers": tiers,
    }


def worst(n: int = 5) -> List[DriftRecord]:
    """The ``n`` records with the largest |relative error| (debug aid)."""
    return sorted(
        _RECORDS,
        key=lambda r: abs(r.rel_error) if math.isfinite(r.rel_error) else math.inf,
        reverse=True,
    )[:n]

"""Straggler detection: EWMA step-time monitor with outlier flagging.

At thousand-node scale the slowest participant sets the step time; catching
a drifting node early (thermals, ECC retries, a noisy neighbour on the DCN)
is a restart-or-reshard decision.  :class:`EwmaZScore` is the shared
anomaly core — an EWMA + EW variance over a scalar series with outlier
exclusion and a consecutive-anomaly streak — and :class:`StragglerMonitor`
applies it to step wall-times.  The link-health observatory
(:mod:`repro_torch.obs.health`) applies the *same* detector to per-tier
measured/predicted drift ratios, so step-level and link-level anomaly
detection share one implementation.  A copy of ``repro.runtime.straggler``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


@dataclasses.dataclass
class EwmaZScore:
    """EWMA + EW-variance z-score detector over a scalar series.

    Semantics (unchanged from the original StragglerMonitor):

    * the first value seeds the EWMA and is never an anomaly;
    * z is 0 until ``warmup`` samples have arrived or while the variance is
      still zero (a constant series never self-flags on z alone);
    * a sample with ``z > z_threshold`` is an anomaly: it increments the
      ``consecutive`` streak and is *excluded* from the EWMA so a single
      hiccup cannot poison the baseline;
    * any normal sample resets the streak and updates EWMA/EW-variance.

    ``update`` returns the z-score of the sample (0.0 while warming up).
    Callers that need a second anomaly criterion (the health monitor's
    absolute-ratio floor) use :meth:`note_anomaly` /
    :meth:`note_normal` to drive the streak themselves.
    """

    alpha: float = 0.1
    z_threshold: float = 3.0
    warmup: int = 5
    ewma: Optional[float] = None
    ewvar: float = 0.0
    n: int = 0
    consecutive: int = 0

    def zscore(self, value: float) -> float:
        """z of ``value`` against the current baseline (no state change).

        ``n`` counts samples already folded/excluded, so the sample being
        classified is number ``n + 1`` — the ``>=`` keeps the original
        StragglerMonitor's "flag from sample warmup+1 on" behaviour exact.
        """
        if self.ewma is None:
            return 0.0
        std = math.sqrt(self.ewvar) if self.ewvar > 0 else float("inf")
        if std > 0 and self.n >= self.warmup and math.isfinite(std):
            return (value - self.ewma) / std
        return 0.0

    def is_anomalous(self, value: float) -> bool:
        return self.n >= self.warmup and self.zscore(value) > self.z_threshold

    def note_anomaly(self) -> int:
        """Count an anomalous sample (excluded from the baseline)."""
        self.n += 1
        self.consecutive += 1
        return self.consecutive

    def note_normal(self, value: float) -> None:
        """Fold a normal sample into the baseline; reset the streak."""
        self.n += 1
        self.consecutive = 0
        if self.ewma is None:
            self.ewma = value
            return
        delta = value - self.ewma
        self.ewma += self.alpha * delta
        self.ewvar = (1 - self.alpha) * (self.ewvar + self.alpha * delta * delta)

    def update(self, value: float) -> float:
        """One-shot record: classify by z alone, then fold or exclude."""
        z = self.zscore(value)
        if self.is_anomalous(value):
            self.note_anomaly()
        else:
            self.note_normal(value)
        return z


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float
    zscore: float


class StragglerMonitor:
    def __init__(
        self,
        alpha: float = 0.1,
        z_threshold: float = 3.0,
        consecutive_for_action: int = 3,
        warmup_steps: int = 5,
    ):
        self.detector = EwmaZScore(
            alpha=alpha, z_threshold=z_threshold, warmup=warmup_steps
        )
        self.consecutive_for_action = consecutive_for_action
        self.events: List[StragglerEvent] = []

    # legacy attribute views (train.py and tests read these directly)
    @property
    def ewma(self) -> Optional[float]:
        return self.detector.ewma

    @property
    def consecutive_slow(self) -> int:
        return self.detector.consecutive

    def record(self, step: int, duration: float) -> Optional[StragglerEvent]:
        det = self.detector
        if det.ewma is None:
            det.note_normal(duration)
            return None
        z = det.zscore(duration)
        if det.is_anomalous(duration):
            # outliers are *flagged* but excluded from the EWMA so a single
            # hiccup doesn't poison the baseline
            det.note_anomaly()
            ev = StragglerEvent(step, duration, det.ewma, z)
            self.events.append(ev)
            return ev
        det.note_normal(duration)
        return None

    @property
    def should_mitigate(self) -> bool:
        """Persistent slowness -> advise checkpoint + reshard/restart."""
        return self.detector.consecutive >= self.consecutive_for_action

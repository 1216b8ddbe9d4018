"""Straggler detection: an EWMA step-time monitor that flags outliers.

The part of ``repro.runtime.straggler`` that the training loop uses, with
its semantics: a step whose wall time lies more than ``z_threshold``
exponentially weighted standard deviations above the EWMA is flagged as
slow and left out of the baseline; ``consecutive_for_action`` slow steps
in a row advise checkpoint and restart.  ``launch.train`` feeds it each
step's wall time.
"""
from __future__ import annotations

import math
from typing import Optional


class StragglerMonitor:
    def __init__(
        self,
        alpha: float = 0.1,
        z_threshold: float = 3.0,
        consecutive_for_action: int = 3,
        warmup_steps: int = 5,
    ):
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.consecutive_for_action = consecutive_for_action
        self.warmup_steps = warmup_steps
        self.ewma: Optional[float] = None
        self.ewvar = 0.0
        self.n = 0  # samples seen, slow ones included
        self.consecutive_slow = 0

    def record(self, duration: float) -> bool:
        """Classify one step's wall time; returns whether it was slow.  The
        first sample seeds the EWMA; none is slow before ``warmup_steps``
        samples have arrived or while the variance is still zero."""
        slow = (self.ewma is not None and self.n >= self.warmup_steps and self.ewvar > 0
                and (duration - self.ewma) / math.sqrt(self.ewvar) > self.z_threshold)
        self.n += 1
        if slow:
            self.consecutive_slow += 1
        elif self.ewma is None:
            self.ewma = duration
        else:
            self.consecutive_slow = 0
            delta = duration - self.ewma
            self.ewma += self.alpha * delta
            self.ewvar = (1 - self.alpha) * (self.ewvar + self.alpha * delta * delta)
        return slow

    @property
    def should_mitigate(self) -> bool:
        """Persistent slowness -> advise checkpoint + reshard/restart."""
        return self.consecutive_slow >= self.consecutive_for_action

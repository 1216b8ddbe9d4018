"""Static analysis of schedules and machine specs ("simlint").

Four checkers, all running without the DES engine (DESIGN.md §9):

* :mod:`repro_torch.analysis.dag` — structural DAG verification (cycles, dangling
  deps, non-finite prices, release misuse) plus an optional post-run audit.
* :mod:`repro_torch.analysis.conservation` — byte accounting against collective
  closed forms and against ``Traversal`` declarations.
* :mod:`repro_torch.analysis.contention` — resource-aliasing soundness for
  composed schedules (the §6.1 cross-family merge).
* :mod:`repro_torch.analysis.specs` — machine-spec plausibility (units,
  magnitudes, locality ordering, fit residuals).

This package also hosts the **strict-validation seam**: when enabled,
``lower_strategy`` / ``candidate_schedules`` / ``compose_schedules`` run
:func:`verify` on every schedule they build and raise
:class:`ScheduleValidationError` on error-severity findings.  Off by
default (zero hot-path cost beyond one flag check); tests/conftest.py turns
it on for the whole suite, and ``REPRO_STRICT_VALIDATION=1`` turns it on
anywhere.  The CLI lives in :mod:`repro_torch.analysis.lint` (not imported here:
it imports :mod:`repro_torch.core.schedule`, which imports this package).
"""
from __future__ import annotations

import os
from typing import List, Optional

from repro_torch.analysis.conservation import (
    check_collective,
    check_lowering,
    check_node_aware,
    collective_bytes,
    declared_bytes,
)
from repro_torch.analysis.contention import analyze_contention, resource_tier
from repro_torch.analysis.dag import verify_result, verify_schedule
from repro_torch.analysis.findings import (
    ERROR,
    INFO,
    WARNING,
    Finding,
    ScheduleValidationError,
    errors,
    sort_findings,
)
from repro_torch.analysis.specs import check_fit_residuals, lint_spec
from repro_torch.core.events import Schedule

__all__ = [
    "ERROR", "INFO", "WARNING", "Finding", "ScheduleValidationError",
    "analyze_contention", "check_collective", "check_fit_residuals",
    "check_lowering", "check_node_aware", "collective_bytes",
    "declared_bytes", "errors",
    "lint_spec", "maybe_verify", "resource_tier", "set_strict",
    "sort_findings", "strict_enabled", "verify", "verify_result",
    "verify_schedule",
]

# tri-state: True/False force; None defers to REPRO_STRICT_VALIDATION
_STRICT: Optional[bool] = None


def set_strict(on: Optional[bool]) -> None:
    """Force strict validation on/off; None defers to the environment."""
    global _STRICT
    _STRICT = on


def strict_enabled() -> bool:
    if _STRICT is not None:
        return _STRICT
    return os.environ.get("REPRO_STRICT_VALIDATION", "").lower() not in (
        "", "0", "false", "off",
    )


def verify(schedule: Schedule) -> List[Finding]:
    """Full static verification of one schedule: DAG + contention."""
    return verify_schedule(schedule) + analyze_contention(schedule)


def maybe_verify(schedule: Schedule) -> Schedule:
    """The seam the schedule builders call on every freshly built schedule.

    No-op unless strict validation is on; then raises
    :class:`ScheduleValidationError` listing all error-severity findings
    (warnings and info never gate here — the CLI reports those).
    """
    if strict_enabled():
        errs = errors(verify(schedule))
        if errs:
            raise ScheduleValidationError(schedule.name, errs)
    return schedule

"""Finding vocabulary for the static schedule/spec verifier ("simlint").

A :class:`Finding` is one violated (or suspicious) invariant, attributed to
a schedule, step, resource or machine tier.  Severities form a gate ladder:

* ``error``   — structurally broken: the engine would crash, hang, or price
                the wrong physics (cycle, dangling dep, unknown resource,
                non-finite price, aliased-but-unshared link pool).  The CI
                ``simlint`` job and the strict-validation seam gate on zero
                of these.
* ``warning`` — suspicious but runnable: a transfer step declaring zero
                bytes, a beta magnitude far outside transport reality.
* ``info``    — observations worth surfacing, expected on the paper's own
                verbatim tables (locality-ordering inversions up to ~6x,
                the one ``suspect``-flagged Lassen rendezvous segment).

Findings are plain data (JSON-serializable via :meth:`Finding.to_dict`) so
the CLI report, the CI artifact, and test assertions all consume one shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated or suspicious invariant.

    ``check`` is the stable machine-readable rule id (``dag.cycle``,
    ``conservation.allreduce_bytes``, ``contention.aliased_pools``,
    ``spec.tier_ordering``); ``subject`` the schedule/machine it was found
    in; ``detail`` the human sentence with the offending values.
    """

    check: str
    severity: str
    subject: str
    detail: str
    step: Optional[str] = None
    resource: Optional[str] = None

    def __post_init__(self):
        if self.severity not in _SEVERITY_ORDER:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> Dict[str, str]:
        d = {
            "check": self.check,
            "severity": self.severity,
            "subject": self.subject,
            "detail": self.detail,
        }
        if self.step is not None:
            d["step"] = self.step
        if self.resource is not None:
            d["resource"] = self.resource
        return d


def sort_findings(findings: List[Finding]) -> List[Finding]:
    """Errors first, then warnings, then info; stable within a severity."""
    return sorted(
        findings,
        key=lambda f: (_SEVERITY_ORDER[f.severity], f.check, f.subject),
    )


def errors(findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


class ScheduleValidationError(ValueError):
    """Raised by the strict-validation seam when error findings exist.

    Carries the findings so callers (and pytest failures) show the full
    list, not just the first.
    """

    def __init__(self, subject: str, findings: List[Finding]):
        self.findings = list(findings)
        lines = [f"schedule validation failed for {subject!r}:"]
        lines += [
            f"  [{f.severity}] {f.check}: {f.detail}" for f in self.findings
        ]
        super().__init__("\n".join(lines))

"""Failure types of the fault-tolerant loop.

A copy of the exceptions of ``repro.runtime.fault``:

* :class:`InjectedFault` — a transient step failure; restart from the
  latest checkpoint on the same mesh.
* :class:`HostLost` — a participant is *gone*.  It carries the lost rank so
  a recovery hook can shrink the machine spec
  (:func:`repro_torch.core.machine.shrink_spec`, re-registered through
  :func:`repro_torch.runtime.elastic.shrink_and_replan`) before going on.
  :meth:`repro_torch.runtime.scenarios.ScenarioInjector.fault_hook` raises it.

The reference's ``run_with_recovery`` (checkpoint/restart with seeded
exponential backoff), ``BackoffPolicy``, ``LoopState`` and
``RecoveryExhausted`` are not ported yet: they come with distribution.
"""
from __future__ import annotations

from typing import Optional


class InjectedFault(RuntimeError):
    """Test hook standing in for a node failure."""


class HostLost(InjectedFault):
    """A participant rank is gone (not coming back without a reshape).

    Carries the lost rank so recovery hooks can shrink the mesh spec
    (:func:`repro_torch.core.machine.shrink_spec`) before the replay resumes.
    """

    def __init__(self, host: int, msg: Optional[str] = None):
        super().__init__(msg or f"host {host} lost")
        self.host = int(host)

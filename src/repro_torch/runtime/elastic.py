"""Elastic re-scale as a planning event.

A host drop is not just a re-placement but a re-decision.
:func:`shrink_and_replan` derives the surviving-mesh spec
(:func:`repro_torch.core.machine.shrink_spec`) and routes it through
:func:`repro_torch.obs.health.request_replan`: re-registration under the
old name bumps the registry generation and the shrunk fingerprint misses
every cached plan, so the very next ``select_*`` call plans for the world
that actually survives.

A copy of ``repro.runtime.elastic.shrink_and_replan``.  The rest of the
reference module (``reshard_tree``, ``restore_on_mesh`` and
``host_drop_drill``, built on ``run_with_recovery``) comes with
distribution and is not ported yet.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union


def shrink_and_replan(
    machine: str,
    lost_hosts: Union[int, Iterable[int]],
    *,
    spec=None,
    total_ranks: Optional[int] = None,
):
    """Shrink the registered spec around lost hosts and trigger a re-plan.

    Resolves ``machine`` (or uses ``spec``), derives the surviving-mesh
    spec via :func:`repro_torch.core.machine.shrink_spec`, and re-registers
    it through :func:`repro_torch.obs.health.request_replan` with
    ``reason="host_drop"``: generation bump + fingerprint change means no
    cached plan computed against the dead world can ever be served again.
    Counts ``runtime.elastic.reshapes`` (plus health's ``health.replans`` /
    ``health.replan.host_drop``).  Returns the shrunk spec.
    """
    from repro_torch.core.machine import resolve_spec, shrink_spec
    from repro_torch.obs import health as obs_health
    from repro_torch.obs import metrics as obs_metrics

    base = spec if spec is not None else resolve_spec(machine)
    shrunk = shrink_spec(base, lost_hosts, total_ranks=total_ranks)
    obs_health.request_replan(machine, reason="host_drop", spec=shrunk)
    if obs_metrics._ENABLED:
        obs_metrics.inc("runtime.elastic.reshapes")
    return shrunk

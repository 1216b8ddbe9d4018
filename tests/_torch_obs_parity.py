"""Shared fixture and helpers of the tests that hold the port's observability,
autotune, scenarios and serve drills against the JAX package's.

The machine registry, the plan and lowering caches, the metrics registry,
the tracer, the drift ledger and the link-health monitor are process-global
in both packages, and a drill re-registers ``tpu_v5e`` degraded or shrunk.
The repository's conftest resets only the reference's caches and
observability, so every test here starts and ends with both packages'
``tpu_v5e`` back to the built-in, both caches empty and both ``obs`` cold.
"""
import pytest
import torch

import repro.comms.autotune as r_autotune
import repro.core as r_core
import repro.obs as r_obs
import repro_torch.analysis as t_analysis
import repro_torch.comms.autotune as t_autotune
import repro_torch.core as t_core
import repro_torch.obs as t_obs
from _torch_core_parity import same  # noqa: F401  (re-exported for the test files)

PACKAGES = ((r_core, r_autotune, r_obs), (t_core, t_autotune, t_obs))

# the metric families the serve loop's planner, engine, health monitor and
# drills write; each must end equal in both packages
SHARED_PREFIXES = ("plan_cache.", "lowering_memo.", "engine.", "health.", "runtime.")


def fresh_both() -> None:
    """Both packages' ``tpu_v5e`` back to the built-in, empty plan and
    lowering caches, metrics off and empty, no tracer, no drift, a fresh
    link-health monitor."""
    for core, autotune, obs in PACKAGES:
        core.register_machine("tpu_v5e", core.machine.tpu_machine_spec)
        autotune.clear_plan_cache()
        core.schedule.clear_schedule_cache()
        obs.reset_all()


@pytest.fixture(autouse=True)
def _fresh_planners():
    torch.set_num_threads(1)
    t_analysis.set_strict(True)  # the repo conftest arms the reference's only
    fresh_both()
    yield
    fresh_both()
    t_analysis.set_strict(None)


def shared_metrics(metrics_module) -> dict:
    """Counters and gauges of ``SHARED_PREFIXES`` in one package's registry."""
    snap = metrics_module.to_json()
    return {k: v for kind in ("counters", "gauges") for k, v in snap[kind].items()
            if k.startswith(SHARED_PREFIXES)}

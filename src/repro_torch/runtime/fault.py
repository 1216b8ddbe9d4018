"""Fault-tolerant training loop: checkpoint/restart with failure injection.

Ported from ``repro.runtime.fault``.  ``run_with_recovery`` wraps a step
function.  On a step exception (an injected :class:`InjectedFault` in
tests; a lost rank in a world) it restores the latest complete checkpoint
and replays: the deterministic data pipeline (``data.SyntheticLM``) makes
the recovery bitwise-exact, which tests assert.  Both the initial resume and
the in-loop restart restore the full ``{"params", "opt"}`` blob the loop
saves: optimizer state always comes from the checkpoint, never from the
live process.

Failure taxonomy:

* :class:`InjectedFault` — a transient step failure; restart from the
  latest checkpoint on the same mesh.
* :class:`HostLost` — a participant is *gone*.  It carries the lost rank, and
  the loop calls the ``on_host_drop`` hook before restoring: the hook is
  where the machine spec is shrunk and re-registered
  (:func:`repro_torch.runtime.elastic.shrink_and_replan`), so the replay
  plans against the surviving world.
  :meth:`repro_torch.runtime.scenarios.ScenarioInjector.fault_hook` raises it.
* :class:`RecoveryExhausted` — the restart budget ran out.  Raised typed
  (step, restart count, last error) and counted under
  ``runtime.recovery.exhausted``.

Restarts back off exponentially with deterministic jitter
(:class:`BackoffPolicy`, the reference's floats exactly: both draw from
``random.Random(f"{seed}:{attempt}")``), slept through ``sleep_fn`` and
observed as ``runtime.recovery.backoff_s``.  When metrics are enabled the
loop counts steps, restarts, host drops, straggler flags and mitigation
advisories (``runtime.*``); the first time in an episode that the straggler
monitor advises mitigation, the loop routes one
``obs.health.request_replan(reason="straggler")``.

What differs from the reference: its trees are immutable arrays, the
port's are tensors that ``step_fn`` may update in place (``train_step``
does).  A restore hands the loop new tensors read from the checkpoint, and
until the first checkpoint is saved the loop keeps a copy of the initial
trees, for a restart with no checkpoint to restore.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.models.convert import tree_map
from repro_torch.runtime.straggler import StragglerMonitor


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


class RecoveryExhausted(RuntimeError):
    """``run_with_recovery`` spent its restart budget without finishing."""

    def __init__(self, step: int, restarts: int, last_error: BaseException):
        super().__init__(
            f"recovery exhausted after {restarts} restart(s) at step {step}: "
            f"{type(last_error).__name__}: {last_error}"
        )
        self.step = int(step)
        self.restarts = int(restarts)
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with deterministic, seeded jitter.

    ``delay(attempt)`` for attempt 1, 2, ... is
    ``min(base * multiplier**(attempt-1), max_delay)`` scaled by a jitter
    draw in ``[1 - jitter, 1]``.  The draw is a pure function of
    ``(seed, attempt)``, so two processes with different seeds decorrelate
    while one process replays identical delays.
    """

    base: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.5  # fraction of the delay the draw may remove
    seed: int = 0

    def __post_init__(self):
        if self.base < 0 or self.multiplier < 1 or self.max_delay < 0:
            raise ValueError(f"bad backoff policy {self}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter {self.jitter} must be in [0, 1]")

    def delay(self, attempt: int) -> float:
        if attempt < 1:
            raise ValueError(f"attempt {attempt} must be >= 1")
        d = min(self.base * self.multiplier ** (attempt - 1), self.max_delay)
        u = random.Random(f"{self.seed}:{attempt}").random()
        return d * (1.0 - self.jitter * u)


@dataclasses.dataclass
class LoopState:
    step: int
    params: Any
    opt_state: Any


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def run_with_recovery(
    *,
    step_fn: Callable[[Any, Any, Dict], tuple],  # (params, opt, batch) -> (p, o, metrics)
    batch_fn: Callable[[int], Dict],
    init_params: Any,
    init_opt: Any,
    checkpointer: Checkpointer,
    total_steps: int,
    checkpoint_every: int = 50,
    fault_hook: Optional[Callable[[int], None]] = None,  # raise to inject
    max_restarts: int = 8,
    monitor: Optional[StragglerMonitor] = None,
    backoff: Optional[BackoffPolicy] = None,
    sleep_fn: Callable[[float], None] = time.sleep,
    on_host_drop: Optional[Callable[[HostLost, int], None]] = None,
    log: Callable[[str], None] = lambda s: None,
) -> LoopState:
    params, opt = init_params, init_opt
    initial = None  # the initial trees while no checkpoint holds a state
    start = 0
    latest = checkpointer.latest_step()
    if latest is not None:
        # the loop saves {"params", "opt"} blobs; resume must restore the
        # same shape so the optimizer state comes from the checkpoint too
        blob = checkpointer.restore(latest, {"params": params, "opt": opt})
        params, opt = blob["params"], blob["opt"]
        start = latest
        log(f"resumed from step {latest}")
    else:
        initial = _copy((init_params, init_opt))

    # lazy, as in the reference: obs pulls from this package the other way
    from repro_torch.obs import metrics as obs_metrics

    restarts = 0
    step = start
    metrics = {}
    mitigation_requested = False
    while step < total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            t0 = time.perf_counter()
            batch = batch_fn(step)
            params, opt, metrics = step_fn(params, opt, batch)
            dt = time.perf_counter() - t0
            if obs_metrics._ENABLED:
                obs_metrics.inc("runtime.steps")
            if monitor is not None:
                ev = monitor.record(step, dt)
                if ev is not None:
                    log(f"straggler flag at step {step}: {dt:.3f}s (z={ev.zscore:.1f})")
                    if obs_metrics._ENABLED:
                        obs_metrics.inc("runtime.straggler.flags")
                if monitor.should_mitigate and not mitigation_requested:
                    # persistent slowness: advise checkpoint + re-plan once
                    # per episode (the advisory stays up until a normal
                    # step resets the streak)
                    mitigation_requested = True
                    if obs_metrics._ENABLED:
                        obs_metrics.inc("runtime.straggler.mitigate")
                    from repro_torch.obs import health as obs_health

                    obs_health.request_replan(reason="straggler")
                    log(f"straggler mitigation advised at step {step}")
                elif not monitor.should_mitigate:
                    mitigation_requested = False
            step += 1
            if step % checkpoint_every == 0 or step == total_steps:
                checkpointer.save(step, {"params": params, "opt": opt}, block=False)
                initial = None
        except InjectedFault as e:
            restarts += 1
            if restarts > max_restarts:
                # flush in-flight async saves before dying: the successor
                # process resumes from whatever this one managed to write
                checkpointer.wait()
                if obs_metrics._ENABLED:
                    obs_metrics.inc("runtime.recovery.exhausted")
                raise RecoveryExhausted(step, restarts - 1, e) from e
            if obs_metrics._ENABLED:
                obs_metrics.inc("runtime.restarts")
            if isinstance(e, HostLost):
                if obs_metrics._ENABLED:
                    obs_metrics.inc("runtime.elastic.host_drops")
                if on_host_drop is not None:
                    # reshape *before* restoring: the hook shrinks and
                    # re-registers the mesh spec, so the replay below
                    # already plans against the surviving world
                    on_host_drop(e, step)
            if backoff is not None:
                d = backoff.delay(restarts)
                if obs_metrics._ENABLED:
                    obs_metrics.observe("runtime.recovery.backoff_s", d)
                if d > 0:
                    sleep_fn(d)
            checkpointer.wait()
            latest = checkpointer.latest_step()
            log(f"fault at step {step} ({e}); restarting from {latest}")
            if latest is not None:
                # new tensors: the live ones go (a step may have half-updated them)
                params = opt = None
                blob = checkpointer.restore(latest, {"params": init_params, "opt": init_opt})
                params, opt = blob["params"], blob["opt"]
                step = latest
            else:
                params, opt = _copy(initial)
                step = 0
    checkpointer.wait()
    return LoopState(step=step, params=params, opt_state=opt)

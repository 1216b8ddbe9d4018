"""Link-health observatory: drift records -> degradation state -> re-plan.

The drift ledger (:mod:`repro_torch.obs.drift`) *records* when
``tier.time(nbytes)`` diverges from measurement.  This module closes the loop
the paper's
"nearby jobs" variance story demands:

* every :class:`~repro_torch.obs.drift.DriftRecord` is streamed (via the ledger's
  ``_on_record`` hook) into a per-``(machine, tier)`` :class:`LinkHealth`,
  whose anomaly detector is the *same* EWMA z-score implementation the
  straggler monitor uses on step times
  (:class:`repro_torch.runtime.straggler.EwmaZScore`) applied to the
  measured/predicted ratio, plus an absolute ratio floor (a constant
  warm-up series has zero variance, so z alone can never fire — the floor
  catches the cold-start sag);
* sustained anomalies walk a state machine
  ``healthy -> suspect -> degraded -> recovered -> healthy``; every
  transition increments a ``health.transition.{from}_to_{to}`` counter,
  updates the ``health.links.degraded`` gauge, and paints a ``degraded:``
  interval onto the active Chrome trace;
* a degraded link carries its recent measured samples, so
  :func:`refit_degraded` can hand them to :mod:`repro_torch.obs.congestion` and
  re-register a fitted degraded-variant spec — whose changed fingerprint
  invalidates the plan cache, making the serve path's next
  ``select_*_strategy`` call re-plan with no cache-flush choreography
  (DESIGN.md §10).  :func:`request_replan` is the shared trigger; the
  straggler/fault runtime routes through it too.

The module is import-light on purpose: :mod:`repro_torch.core` and
:mod:`repro_torch.comms` are imported lazily inside functions
(``core.schedule`` imports ``repro_torch.obs`` at module scope), and so is
the shared detector from ``repro_torch.runtime``, as the reference does.

CLI: ``python -m repro_torch.obs.health --json`` reports the live monitor (or
a snapshot written by ``launch/serve.py --health-out``, with ``--load PATH``);
``--drill [--out PATH]`` runs the synthetic end-to-end degradation drill.
A copy of ``repro.obs.health``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics, trace

HEALTHY = "healthy"
SUSPECT = "suspect"
DEGRADED = "degraded"
RECOVERED = "recovered"

# state -> states it may legally move to (the full machine; pinned in tests)
TRANSITIONS = {
    HEALTHY: (SUSPECT,),
    SUSPECT: (HEALTHY, DEGRADED),
    DEGRADED: (RECOVERED,),
    RECOVERED: (HEALTHY, SUSPECT),
}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds for the per-link state machine.

    ``ratio_threshold`` is the absolute measured/predicted floor (1.5 =
    "50% slower than the model says"); ``suspect_after``/``degrade_after``
    are consecutive-anomaly streaks; ``recover_after`` consecutive normals
    take a degraded link to recovered and a recovered link to healthy.
    Detector parameters mirror :class:`repro_torch.runtime.straggler.EwmaZScore`.
    """

    ratio_threshold: float = 1.5
    z_threshold: float = 3.0
    ewma_alpha: float = 0.2
    warmup: int = 3
    suspect_after: int = 2
    degrade_after: int = 3
    recover_after: int = 3
    history: int = 64  # measured samples kept per link for refitting


def _new_detector(cfg: HealthConfig):
    # lazy, as in the reference (whose runtime package imports jax)
    from repro_torch.runtime.straggler import EwmaZScore

    return EwmaZScore(
        alpha=cfg.ewma_alpha, z_threshold=cfg.z_threshold, warmup=cfg.warmup
    )


@dataclasses.dataclass
class LinkHealth:
    """Health state of one (machine, tier) link."""

    machine: str
    tier: str
    state: str = HEALTHY
    detector: object = None
    consecutive_normal: int = 0
    n_records: int = 0
    n_anomalies: int = 0
    last_ratio: float = 1.0
    # records seen when the link last entered `degraded` minus records seen
    # at the first anomaly of that streak — the detection latency the bench
    # section bounds
    detection_records: Optional[int] = None
    _streak_start: Optional[int] = None
    _interval_id: Optional[int] = None
    samples: Deque[Tuple[float, float]] = dataclasses.field(
        default_factory=lambda: deque(maxlen=64)
    )
    # the subset recorded while anomalous — what a degraded refit should be
    # fitted FROM (the healthy warm-up samples would dilute the sag)
    anomalous_samples: Deque[Tuple[float, float]] = dataclasses.field(
        default_factory=lambda: deque(maxlen=64)
    )

    @property
    def key(self) -> str:
        return f"{self.machine}/{self.tier}"

    def to_json(self) -> dict:
        det = self.detector
        return {
            "machine": self.machine,
            "tier": self.tier,
            "state": self.state,
            "n_records": self.n_records,
            "n_anomalies": self.n_anomalies,
            "consecutive_anomalies": getattr(det, "consecutive", 0),
            "consecutive_normal": self.consecutive_normal,
            "last_ratio": self.last_ratio,
            "ratio_ewma": getattr(det, "ewma", None),
            "detection_records": self.detection_records,
        }


class HealthMonitor:
    """All links' health, fed by the drift ledger's record hook."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self.links: Dict[Tuple[str, str], LinkHealth] = {}
        self.replans: List[dict] = []
        self.n_transitions = 0
        self._callbacks: List[Callable[[LinkHealth, str, str], None]] = []

    # -- observation --------------------------------------------------------

    def link(self, machine: str, tier: str) -> LinkHealth:
        key = (machine, tier)
        lk = self.links.get(key)
        if lk is None:
            lk = LinkHealth(machine=machine, tier=tier)
            lk.detector = _new_detector(self.config)
            lk.samples = deque(maxlen=self.config.history)
            lk.anomalous_samples = deque(maxlen=self.config.history)
            self.links[key] = lk
        return lk

    def note(self, record: "obs_drift.DriftRecord") -> LinkHealth:
        """Fold one drift record into its link's state machine."""
        cfg = self.config
        lk = self.link(record.machine, record.tier)
        lk.n_records += 1
        lk.samples.append((record.nbytes, record.measured))
        if record.predicted <= 0.0:
            ratio = 1.0 if record.measured <= 0.0 else float("inf")
        else:
            ratio = record.measured / record.predicted
        lk.last_ratio = ratio
        det = lk.detector
        # two criteria, one streak: the z-score catches drift relative to
        # this link's own history; the absolute floor catches a sag during
        # warmup or on a constant series (zero variance -> z stays 0)
        anomalous = ratio >= cfg.ratio_threshold or det.is_anomalous(ratio)
        if anomalous:
            if det.consecutive == 0:
                lk._streak_start = lk.n_records
            lk.anomalous_samples.append((record.nbytes, record.measured))
            det.note_anomaly()
            lk.n_anomalies += 1
            lk.consecutive_normal = 0
            streak = det.consecutive
            if lk.state in (HEALTHY, RECOVERED) and streak >= cfg.suspect_after:
                self._transition(lk, SUSPECT)
            if lk.state == SUSPECT and streak >= cfg.degrade_after:
                lk.detection_records = lk.n_records - lk._streak_start + 1
                self._transition(lk, DEGRADED)
        else:
            det.note_normal(ratio)
            lk.consecutive_normal += 1
            if lk.state == SUSPECT:
                self._transition(lk, HEALTHY)
            elif lk.state == DEGRADED and (
                lk.consecutive_normal >= cfg.recover_after
            ):
                self._transition(lk, RECOVERED)
            elif lk.state == RECOVERED and (
                lk.consecutive_normal >= 2 * cfg.recover_after
            ):
                self._transition(lk, HEALTHY)
        return lk

    def _transition(self, lk: LinkHealth, new_state: str) -> None:
        old = lk.state
        assert new_state in TRANSITIONS[old], (old, new_state)
        lk.state = new_state
        self.n_transitions += 1
        if metrics._ENABLED:
            metrics.inc(f"health.transition.{old}_to_{new_state}")
            metrics.gauge("health.links.degraded", float(self.n_degraded()))
        if new_state == DEGRADED:
            lk._interval_id = trace.begin_interval(
                f"degraded:{lk.key}",
                ratio=lk.last_ratio,
                detection_records=lk.detection_records,
            )
        elif old == DEGRADED and lk._interval_id is not None:
            trace.end_interval(f"degraded:{lk.key}", lk._interval_id)
            lk._interval_id = None
        trace.instant(f"health:{lk.key}", transition=f"{old}->{new_state}")
        for cb in self._callbacks:
            cb(lk, old, new_state)

    def on_transition(
        self, cb: Callable[[LinkHealth, str, str], None]
    ) -> None:
        """Register ``cb(link, old_state, new_state)`` for every transition."""
        self._callbacks.append(cb)

    # -- queries ------------------------------------------------------------

    def n_degraded(self) -> int:
        return sum(1 for lk in self.links.values() if lk.state == DEGRADED)

    def degraded_links(self) -> List[LinkHealth]:
        return [lk for lk in self.links.values() if lk.state == DEGRADED]

    def states(self) -> Dict[str, str]:
        return {lk.key: lk.state for lk in self.links.values()}

    def snapshot(self) -> dict:
        """JSON-serializable full state (the CLI / ``--health-out`` format)."""
        counts: Dict[str, int] = {}
        for lk in self.links.values():
            counts[lk.state] = counts.get(lk.state, 0) + 1
        return {
            "links": {
                lk.key: lk.to_json() for lk in sorted(
                    self.links.values(), key=lambda x: x.key
                )
            },
            "state_counts": counts,
            "n_transitions": self.n_transitions,
            "replans": list(self.replans),
            "drift": {
                "n_records": len(obs_drift.records()),
                "n_evicted": obs_drift.n_evicted(),
            },
        }

    # -- the re-plan trigger -------------------------------------------------

    def request_replan(
        self,
        machine: Optional[str] = None,
        *,
        reason: str = "degraded",
        spec=None,
    ) -> None:
        """Invalidate cached plans so the next planner call re-decides.

        With ``spec``: register it (under ``machine`` or its own name) —
        the registration bumps the registry generation AND the refit spec's
        fingerprint differs, so the plan cache
        (:mod:`repro_torch.comms.autotune`) can never serve a decision computed
        against the superseded machine.  Without ``spec`` (a straggler
        advisory names no fitted replacement): drop the plan cache
        outright.  Either way the *next* ``select_*`` call replans; no
        planner code changes hands.
        """
        if spec is not None:
            from repro_torch.core.machine import register_machine

            register_machine(machine or spec.name, spec)
        else:
            from repro_torch.comms.autotune import clear_plan_cache

            clear_plan_cache()
        self.replans.append({
            "machine": machine or (spec.name if spec is not None else None),
            "reason": reason,
            "refit": spec is not None,
        })
        if metrics._ENABLED:
            metrics.inc("health.replans")
            metrics.inc(f"health.replan.{reason}")


# --------------------------------------------------------------------------
# Module singleton, wired into the drift ledger at import.
# --------------------------------------------------------------------------

_MONITOR = HealthMonitor()


def monitor() -> HealthMonitor:
    return _MONITOR


def reset(config: Optional[HealthConfig] = None) -> HealthMonitor:
    """Fresh monitor (tests; part of ``repro_torch.obs.reset_all``)."""
    global _MONITOR
    _MONITOR = HealthMonitor(config)
    return _MONITOR


def _note_record(record) -> None:
    _MONITOR.note(record)


# the ledger hook dereferences the module global, so reset() needs no
# re-install and a swapped monitor is picked up atomically
obs_drift._on_record = _note_record


def request_replan(machine=None, *, reason="degraded", spec=None) -> None:
    _MONITOR.request_replan(machine, reason=reason, spec=spec)


def refit_degraded(base_spec, link: LinkHealth, *, register_as=None):
    """Fit a degraded-variant spec from a degraded link's sample history.

    The link's retained ``(nbytes, measured)`` samples (the same numbers
    that drove it to ``degraded``) are handed to
    :func:`repro_torch.obs.congestion.fit_degraded_tier`; the variant spec is
    registered via :meth:`HealthMonitor.request_replan` when
    ``register_as`` is given.  Returns ``(fit, degraded_spec)``.
    """
    from repro_torch.obs import congestion

    pool = link.anomalous_samples or link.samples
    sizes = [s for s, _ in pool]
    times = [t for _, t in pool]
    fit = congestion.fit_degraded_tier(base_spec, link.tier, sizes, times)
    degraded = congestion.apply_degradation(base_spec, {link.tier: fit})
    if register_as is not None:
        _MONITOR.request_replan(register_as, reason="degraded", spec=degraded)
    return fit, degraded


# --------------------------------------------------------------------------
# The degradation drill: the end-to-end scenario tests and the bench gate.
# --------------------------------------------------------------------------

def degradation_drill(
    *,
    base_machine: str = "summit",
    machine: str = "obs_drill",
    tier_key: str = "gpu_net:off-node",
    nbytes: float = float(1 << 16),
    n_msgs: int = 8,
    sag: float = 12.0,
    max_records: int = 32,
    config: Optional[HealthConfig] = None,
    monitor_: Optional[HealthMonitor] = None,
) -> dict:
    """Synthetic bandwidth sag, end to end. Returns the full evidence dict.

    1. register ``base_machine``'s spec under the scratch name ``machine``
       and take the planner's (cached) schedule pick — the *stale* plan;
    2. stream warm-up drift records (model == measurement), then sagged
       records (measurement = ``sag`` x model) until the link degrades;
    3. fit the sag from the link's own sample history
       (:func:`refit_degraded`) and register the degraded variant under the
       same scratch name — fingerprint changes, plan cache invalidated;
    4. re-pick, then simulate BOTH picks under the degraded spec: the
       re-planned schedule must strictly beat the stale one.

    Everything is deterministic (no live timing), so the bench section can
    gate it strictly.  Scratch names keep the builtin registry untouched.
    """
    import dataclasses as _dc

    from repro_torch.comms.autotune import plan_cache_info, select_schedule
    from repro_torch.core.machine import get_machine, register_machine
    from repro_torch.core.schedule import search_schedules

    mon = monitor_ or _MONITOR
    if config is not None:
        mon.config = config
    cfg = mon.config

    base = get_machine(base_machine)
    drill_spec = _dc.replace(base, name=machine)
    register_machine(machine, drill_spec)
    stale_pick = select_schedule(machine, nbytes, n_msgs)

    tier = drill_spec.tiers[tier_key]
    t_model = float(tier.time(nbytes))
    # warm-up: the model agrees with measurement
    for _ in range(cfg.warmup):
        obs_drift.record(machine, tier_key, "probe", nbytes, t_model, t_model)
    lk = mon.link(machine, tier_key)
    assert lk.state == HEALTHY, lk.state
    # the sag: nearby job saturates the link; measurements come in slow
    sag_records = 0
    for _ in range(max_records):
        sag_records += 1
        obs_drift.record(
            machine, tier_key, "probe", nbytes, t_model, sag * t_model
        )
        if lk.state == DEGRADED:
            break
    detected = lk.state == DEGRADED
    detection_records = lk.detection_records

    fit, degraded_spec = refit_degraded(drill_spec, lk)
    fingerprint_changed = degraded_spec.fingerprint != drill_spec.fingerprint
    cache_before = plan_cache_info()
    mon.request_replan(machine, reason="degraded", spec=degraded_spec)
    fresh_pick = select_schedule(machine, nbytes, n_msgs)
    cache_after = plan_cache_info()

    # judge both picks under the DEGRADED reality
    results = search_schedules(degraded_spec, nbytes, n_msgs)
    t_stale = float(results[stale_pick].makespan)
    t_fresh = float(results[fresh_pick].makespan)

    return {
        "machine": machine,
        "base_machine": base_machine,
        "tier": tier_key,
        "nbytes": nbytes,
        "n_msgs": n_msgs,
        "sag": sag,
        "detected": detected,
        "sag_records_fed": sag_records,
        "detection_records": detection_records,
        "state": lk.state,
        "fit_alpha_scale": fit.alpha_scale,
        "fit_beta_scale": fit.beta_scale,
        "fit_max_rel_err": fit.max_rel_err,
        "fingerprint_changed": fingerprint_changed,
        "plan_cache_misses_before": cache_before["misses"],
        "plan_cache_misses_after": cache_after["misses"],
        "replanned": fresh_pick != stale_pick,
        "stale_pick": stale_pick,
        "fresh_pick": fresh_pick,
        "t_stale_under_degraded": t_stale,
        "t_fresh_under_degraded": t_fresh,
        "replanned_beats_stale": t_fresh < t_stale,
        "speedup": (t_stale / t_fresh) if t_fresh > 0 else float("inf"),
    }


# --------------------------------------------------------------------------
# CLI.
# --------------------------------------------------------------------------

def _format_report(snap: dict) -> str:
    lines = ["link-health report"]
    links = snap.get("links", {})
    if not links:
        lines.append("  (no links observed)")
    for key, lk in sorted(links.items()):
        lines.append(
            f"  {key}: {lk['state']}  records={lk['n_records']} "
            f"anomalies={lk['n_anomalies']} last_ratio={lk['last_ratio']:.3g}"
            + (
                f" detected_in={lk['detection_records']}"
                if lk.get("detection_records") is not None
                else ""
            )
        )
    lines.append(
        f"  transitions={snap.get('n_transitions', 0)} "
        f"replans={len(snap.get('replans', []))} "
        f"drift_records={snap.get('drift', {}).get('n_records', 0)} "
        f"evicted={snap.get('drift', {}).get('n_evicted', 0)}"
    )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.health",
        description="Report link health (live monitor, snapshot file, or "
                    "the synthetic degradation drill).",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the snapshot as JSON on stdout")
    ap.add_argument("--load", metavar="PATH", default=None,
                    help="report a snapshot written by serve --health-out "
                         "instead of the live monitor")
    ap.add_argument("--drill", action="store_true",
                    help="run the synthetic degradation drill first")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="also write the snapshot JSON to PATH")
    args = ap.parse_args(argv)

    drill_result = None
    if args.drill:
        drill_result = degradation_drill()
    if args.load:
        with open(args.load) as f:
            snap = json.load(f)
    else:
        snap = _MONITOR.snapshot()
    if drill_result is not None:
        snap["drill"] = drill_result
    if args.out:
        with open(args.out, "w") as f:
            json.dump(snap, f, indent=2)
            f.write("\n")
    if args.json:
        json.dump(snap, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        print(_format_report(snap))
        if drill_result is not None:
            ok = drill_result["detected"] and drill_result["replanned_beats_stale"]
            print(
                f"  drill: detected={drill_result['detected']} "
                f"in {drill_result['detection_records']} records, "
                f"{drill_result['stale_pick']} -> {drill_result['fresh_pick']} "
                f"(speedup x{drill_result['speedup']:.2f}) "
                f"{'OK' if ok else 'FAILED'}"
            )
    if drill_result is not None and not (
        drill_result["detected"] and drill_result["replanned_beats_stale"]
    ):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

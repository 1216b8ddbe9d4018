"""Congestion calibration: fit degradation overrides from live measurements.

The paper's motivating observation is that transfer cost "varies greatly
with ... job partition and nearby jobs" — a registered
:class:`~repro_torch.core.machine.MachineSpec` is a *fair-weather* model.  This
module turns measurements taken under congestion into spec overrides, in
two independent directions:

* **Bandwidth sag** (:func:`fit_degraded_tier` + :func:`apply_degradation`):
  given (size, time) samples measured on a sagging link, solve for the
  multiplicative ``(alpha_scale, beta_scale)`` that best maps the healthy
  tier model onto the measurements, and build a degraded-variant spec whose
  affected tiers are wrapped in
  :class:`~repro_torch.core.postal.ScaledPostalModel`.  The variant's fingerprint
  necessarily differs (scaled postal parameters), so re-registering it
  under the same name invalidates every cached plan — re-planning is a
  side effect of honesty about the link, not a separate code path.

* **Contention calibration** (:func:`predict_concurrent` +
  :func:`fit_contention`): the DES engine prices k concurrent transfers on
  a capacity-c resource by queueing theory it has never had checked against
  a measured multi-lane run.  ``fit_contention`` takes
  measured makespans at increasing lane counts, sweeps candidate effective
  capacities through the engine, and returns the capacity (plus a residual
  bandwidth scale) that minimizes relative error — dropping drift records
  for each lane count so the drift ledger watches the calibration
  quality.

This module imports the modeling core (``core.schedule`` → ``core.events``)
at module scope, so ``repro_torch.obs.__init__`` must NOT import it at module
scope (``core.schedule`` imports ``repro_torch.obs`` for trace/metrics — the
cycle is broken by keeping congestion a leaf that callers and
:mod:`repro_torch.obs.health` import lazily).  A copy of
``repro.obs.congestion``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import Resource, Schedule, Step, run_schedule
from repro_torch.core.machine import (
    MachineSpec,
    TransportTier,
    register_machine,
    resolve_spec,
)
from repro_torch.core.postal import ScaledPostalModel
from repro_torch.obs import drift as obs_drift


# --------------------------------------------------------------------------
# Bandwidth sag: measured samples -> multiplicative tier degradation.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradedFit:
    """Multiplicative degradation of one tier, fitted from measurements.

    ``beta_scale`` > 1 means the link delivers 1/beta_scale of its healthy
    bandwidth; ``max_rel_err`` is the worst residual of the scaled model
    against the samples it was fitted from (a sanity number — a clean sag
    fits to ~0, structural change (new protocol cliff) does not).
    """

    tier: str
    alpha_scale: float
    beta_scale: float
    n_samples: int
    max_rel_err: float


def fit_degraded_tier(
    spec: "MachineSpec | str",
    tier_key: str,
    sizes: Sequence[float],
    times: Sequence[float],
) -> DegradedFit:
    """Solve T_meas(s) ~= A*alpha_base(s) + B*beta_base(s)*s for (A, B).

    Weighted least squares in the healthy model's own basis: the protocol
    segmentation is taken as given (congestion moves rates, not protocol
    switch points), so two scalars capture the sag and the fit is stable
    from a handful of samples — cheap enough to run on live drift data.
    Scales are clamped to >= 1e-3 so a degenerate sample set can never
    produce a zero/negative model that ``validate_spec`` would reject.
    """
    spec = resolve_spec(spec)
    tier = spec.tiers[tier_key]
    s = np.asarray(sizes, np.float64)
    t = np.asarray(times, np.float64)
    if s.size == 0:
        raise ValueError("no samples")
    alphas = np.empty_like(s)
    betas = np.empty_like(s)
    for i, v in enumerate(s.flat):
        p = tier.params_for(float(v))
        alphas.flat[i] = p.alpha
        betas.flat[i] = p.beta
    A = np.stack([alphas, betas * s], axis=1)
    w = 1.0 / np.maximum(t, 1e-12)  # relative residuals (matches fit_postal)
    coef, *_ = np.linalg.lstsq(A * w[:, None], t * w, rcond=None)
    alpha_scale = float(max(coef[0], 1e-3))
    beta_scale = float(max(coef[1], 1e-3))
    pred = alpha_scale * alphas + beta_scale * betas * s
    rel = np.abs(pred - t) / np.maximum(t, 1e-30)
    return DegradedFit(
        tier=tier_key,
        alpha_scale=alpha_scale,
        beta_scale=beta_scale,
        n_samples=int(s.size),
        max_rel_err=float(rel.max()),
    )


def apply_degradation(
    spec: "MachineSpec | str",
    fits: Mapping[str, DegradedFit],
    *,
    register_as: Optional[str] = None,
) -> MachineSpec:
    """Degraded-variant spec: affected tiers wrapped in ScaledPostalModel.

    The injection cap ``beta_N`` scales with ``beta_scale`` (a congested
    NIC's node-aggregate rate sags with its per-lane rate).  Everything
    else — paths, strategies, facts — is shared with the base spec, so the
    variant's fingerprint differs *only* through the scaled tier
    parameters; registering it (``register_as``, typically the base spec's
    own name) bumps the registry generation and the new fingerprint misses
    every cached plan key, which is the whole re-plan trigger
    (DESIGN.md §10).
    """
    spec = resolve_spec(spec)
    tiers: Dict[str, TransportTier] = dict(spec.tiers)
    for tier_key, fit in fits.items():
        base = spec.tiers[tier_key]
        if fit.alpha_scale == 1.0 and fit.beta_scale == 1.0:
            continue
        tiers[tier_key] = dataclasses.replace(
            base,
            model=ScaledPostalModel(
                base=base.model,
                alpha_scale=fit.alpha_scale,
                beta_scale=fit.beta_scale,
            ),
            beta_N=None if base.beta_N is None else base.beta_N * fit.beta_scale,
        )
    degraded = dataclasses.replace(
        spec,
        name=register_as or spec.name,
        tiers=tiers,
        description=(
            f"{spec.description} [degraded: "
            + ", ".join(
                f"{k} x{f.beta_scale:.2f}b/{f.alpha_scale:.2f}a"
                for k, f in sorted(fits.items())
            )
            + "]"
        ),
        provenance="fitted",
    )
    if register_as is not None:
        register_machine(register_as, degraded)
    return degraded


# --------------------------------------------------------------------------
# Contention: engine queueing predictions vs measured multi-lane runs.
# --------------------------------------------------------------------------

def predict_concurrent(
    spec: "MachineSpec | str",
    tier_key: str,
    nbytes: float,
    lanes: int,
    *,
    capacity: Optional[int] = None,
    beta_scale: float = 1.0,
) -> float:
    """Engine makespan of ``lanes`` concurrent transfers on one tier pool.

    The resource has ``capacity`` slots (default: the tier's declared
    ``width``), so lanes beyond capacity queue — the engine's contention
    model in its purest form, which is exactly what the measured multi-lane
    run checks.  ``beta_scale`` stretches each transfer's bandwidth term
    (the residual knob :func:`fit_contention` solves for).
    """
    spec = resolve_spec(spec)
    tier = spec.tiers[tier_key]
    cap = int(tier.width if capacity is None else capacity)
    p = tier.params_for(float(nbytes))
    dur = p.alpha + beta_scale * p.beta * float(nbytes)
    res = f"{tier_key}.pool"
    sched = Schedule(
        name=f"concurrent[{tier_key} x{lanes}]",
        steps=tuple(
            Step(
                name=f"xfer.rank{i}",
                duration=dur,
                resources=(res,),
                kind="send",
                alpha_time=p.alpha,
                beta_time=dur - p.alpha,
                nbytes=float(nbytes),
                n_msgs=1.0,
            )
            for i in range(int(lanes))
        ),
        resources={res: Resource(name=res, capacity=cap, tier=tier_key)},
        description="contention-calibration probe",
    )
    return float(run_schedule(sched).makespan)


@dataclasses.dataclass(frozen=True)
class ContentionFit:
    """Effective concurrency of one tier, calibrated against measurement.

    ``capacity`` is the engine capacity whose queueing predictions best
    match the measured lane sweep (use it in ``capacity_overrides`` when
    composing schedules); ``beta_scale`` is the residual per-transfer
    bandwidth stretch after capacity is chosen; ``mean_rel_err`` the
    calibrated model's remaining error over the sweep.
    """

    tier: str
    capacity: int
    beta_scale: float
    declared_width: int
    mean_rel_err: float
    per_lane_rel_err: Tuple[float, ...]

    @property
    def capacity_overrides(self) -> Dict[str, int]:
        return {f"{self.tier}.pool": self.capacity}


def fit_contention(
    spec: "MachineSpec | str",
    tier_key: str,
    nbytes: float,
    lane_counts: Sequence[int],
    measured: Sequence[float],
    *,
    machine: Optional[str] = None,
    max_capacity: Optional[int] = None,
) -> ContentionFit:
    """Calibrate the engine's contention model against a measured lane sweep.

    For each candidate capacity c in 1..max(width, max lanes): scale each
    prediction by the single ``beta_scale`` that best matches the
    measurements in least-squares (closed form: sum(m*p)/sum(p*p)), then
    score mean |rel err|.  The winning (capacity, beta_scale) is the
    engine-consistent explanation of the measured contention — capacity
    says how many transfers genuinely proceed in parallel, beta_scale says
    how much each lane's effective bandwidth sags when sharing.

    Every (lane count, prediction, measurement) triple becomes a drift
    record under collective ``"contention"``, so the calibration residual
    is tracked by the same ledger (and compare gate) as the postal fits.
    """
    spec = resolve_spec(spec)
    tier = spec.tiers[tier_key]
    lanes = [int(k) for k in lane_counts]
    m = np.asarray(measured, np.float64)
    if len(lanes) != m.size or m.size == 0:
        raise ValueError("lane_counts and measured must align and be non-empty")
    cap_hi = int(max_capacity or max(tier.width, max(lanes)))
    best: Optional[Tuple[float, int, float, np.ndarray]] = None
    for cap in range(1, cap_hi + 1):
        pred = np.asarray(
            [predict_concurrent(spec, tier_key, nbytes, k, capacity=cap)
             for k in lanes]
        )
        denom = float(np.dot(pred, pred))
        scale = float(np.dot(m, pred) / denom) if denom > 0 else 1.0
        scale = max(scale, 1e-3)
        scaled = pred * scale
        rel = np.abs(scaled - m) / np.maximum(m, 1e-30)
        score = float(rel.mean())
        if best is None or score < best[0]:
            best = (score, cap, scale, scaled)
    score, cap, scale, scaled = best
    name = machine or spec.name
    for k, p, t in zip(lanes, scaled, m):
        obs_drift.record(
            name, tier_key, "contention", float(nbytes) * k, float(p), float(t)
        )
    rel = np.abs(scaled - m) / np.maximum(m, 1e-30)
    return ContentionFit(
        tier=tier_key,
        capacity=cap,
        beta_scale=scale,
        declared_width=tier.width,
        mean_rel_err=score,
        per_lane_rel_err=tuple(float(x) for x in rel),
    )

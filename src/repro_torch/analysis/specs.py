"""Machine-spec linting: units, magnitudes, locality ordering, fit residuals.

:func:`repro_torch.core.machine.validate_spec` already hard-rejects non-finite or
negative parameters at registration.  This module layers the *plausibility*
lints on top — the checks that need judgment rather than arithmetic:

* **magnitude** (warning) — alpha is seconds and beta seconds/byte; values
  outside the envelope spanned by on-chip interconnects and WAN-grade
  networks are almost certainly a units slip (ms-as-s, GB/s-as-s/B).
* **tier ordering** (info / error) — crossing a socket, then a node
  boundary should not get *cheaper*.  The paper's own verbatim tables
  violate the naive rule (Summit's off-node GPU alpha undercuts its
  on-socket one by ~3x — eager-protocol rendezvous effects), so mild
  inversions are reported as info; only decimal-slip-scale inversions
  (>50x) gate as errors.
* **suspect params** (info) — segments the table transcription flags as
  verbatim-but-physically-odd (``PostalParams.suspect``).
* **fit residuals** (warning) — for specs built by
  :func:`repro_torch.core.benchmark.spec_from_measurements`, the fitted model
  should reproduce the measurements it was fitted to; large relative
  residuals mean the segment layout missed a protocol boundary.
* **shape consistency** (error) — tier lane widths must agree with the
  shape facts that derived them (``gpus_per_node`` ↔ ``gpu_net`` width,
  ``hosts_per_pod`` ↔ ``dcn`` width), and a derived spec
  (:func:`repro_torch.core.machine.shrink_spec` output, health refits) must keep
  its provenance lineage and carry mutually consistent ``n_gpus``/``ppn``
  facts — a shrunk spec whose facts disagree with its widths would plan
  for a mesh that doesn't exist.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Mapping, Tuple

from repro_torch.core.machine import MachineSpec, _PROBE_SIZES

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding

# generous physical envelope: NVLink-C2C-class latency/bandwidth out to
# WAN-class; anything outside is a units mistake, not an exotic machine
_ALPHA_RANGE = (1e-9, 1e-2)     # seconds
_BETA_RANGE = (1e-14, 1e-6)     # seconds / byte

# ordering inversions beyond this ratio gate as errors (a decimal slip);
# the paper's own verbatim inversions top out around 6x
_ORDERING_HARD_RATIO = 50.0

_LOCALITY_ORDER = ("on-socket", "on-node", "off-node")
_SOCKET_ORDER = ("on-socket", "off-socket")


def lint_spec(spec: MachineSpec) -> List[Finding]:
    """All plausibility findings for one machine spec."""
    out: List[Finding] = []
    sub = spec.name

    # data-quality provenance: a spec whose constants nobody measured
    # ("representative" placeholders like the gh200 entry) or that came
    # from a live fit should say so in every lint report, so decisions
    # made against it carry the right confidence
    if spec.provenance != "measured":
        out.append(Finding(
            "spec.provenance", INFO, sub,
            f"constants are {spec.provenance!r}, not measured — "
            + ("plausible figures with no hardware behind them; replace "
               "with measurements when the machine is reachable"
               if spec.provenance == "representative"
               else "live-fitted parameters; see the drift ledger for "
                    "fit residuals"),
        ))

    for key, tier in spec.tiers.items():
        suspect_seen = set()
        for s in _PROBE_SIZES:
            p = tier.params_for(s)
            for label, v, (lo, hi) in (
                ("alpha", p.alpha, _ALPHA_RANGE),
                ("beta", p.beta, _BETA_RANGE),
            ):
                if v != 0.0 and not (lo <= v <= hi):
                    out.append(Finding(
                        "spec.magnitude", WARNING, sub,
                        f"tier {key!r}: {label} {v:.3e} at {s:.0f} bytes is "
                        f"outside the plausible range [{lo:.0e}, {hi:.0e}] "
                        f"— units slip?",
                        resource=key,
                    ))
                    break  # one magnitude finding per tier is enough
            if getattr(p, "suspect", False):
                sig = (p.alpha, p.beta)
                if sig not in suspect_seen:
                    suspect_seen.add(sig)
                    out.append(Finding(
                        "spec.suspect_param", INFO, sub,
                        f"tier {key!r}: segment (alpha={p.alpha:.3e}, "
                        f"beta={p.beta:.3e}) is flagged suspect (verbatim "
                        f"paper value, physically odd)",
                        resource=key,
                    ))

    # locality ordering per tier family ("gpu_net:on-socket" etc.)
    families: dict = {}
    for key in spec.tiers:
        base, sep, qual = key.partition(":")
        if sep:
            families.setdefault(base, {})[qual] = spec.tiers[key]
    for base, quals in families.items():
        order = (
            _LOCALITY_ORDER
            if any(q in quals for q in ("on-node", "off-node"))
            else _SOCKET_ORDER
        )
        present = [q for q in order if q in quals]
        for near, far in zip(present, present[1:]):
            # worst inversion over all probe sizes, one finding per term
            worst = {"alpha": None, "beta": None}
            for s in _PROBE_SIZES:
                pn = quals[near].params_for(s)
                pf = quals[far].params_for(s)
                suspect = (
                    getattr(pn, "suspect", False)
                    or getattr(pf, "suspect", False)
                )
                for label, vn, vf in (
                    ("alpha", pn.alpha, pf.alpha),
                    ("beta", pn.beta, pf.beta),
                ):
                    if vf >= vn or vn <= 0.0:
                        continue
                    ratio = vn / vf if vf > 0 else math.inf
                    cur = worst[label]
                    if cur is None or ratio > cur[0]:
                        worst[label] = (ratio, s, vn, vf, suspect)
            for label, hit in worst.items():
                if hit is None:
                    continue
                ratio, s, vn, vf, suspect = hit
                # a segment the transcription already flags suspect never
                # hard-gates: the oddity is acknowledged, not a new typo
                sev = (
                    ERROR if ratio > _ORDERING_HARD_RATIO and not suspect
                    else INFO
                )
                out.append(Finding(
                    "spec.tier_ordering", sev, sub,
                    f"tier {base!r}: {label} at {s:.0f} bytes is "
                    f"{ratio:.1f}x cheaper {far} ({vf:.3e}) than {near} "
                    f"({vn:.3e})"
                    + ("" if sev == ERROR else
                       " — verbatim table quirk, not gating"),
                    resource=f"{base}:{far}",
                ))

    out.extend(_lint_shape_consistency(spec))
    return out


# tier families whose lane width is derived from a shape fact; every
# builtin + fitted spec satisfies these, so a mismatch is a real error
# (most likely a hand-rolled "shrunk" spec that edited one side only)
_WIDTH_FACTS = (("gpu_net", "gpus_per_node"), ("dcn", "hosts_per_pod"))


def _lint_shape_consistency(spec: MachineSpec) -> List[Finding]:
    out: List[Finding] = []
    sub = spec.name
    for base, fact in _WIDTH_FACTS:
        if fact not in spec.facts:
            continue
        want = int(spec.facts[fact])
        for key, tier in spec.tiers.items():
            if key.partition(":")[0] != base:
                continue
            if tier.width != want:
                out.append(Finding(
                    "spec.width_fact_mismatch", ERROR, sub,
                    f"tier {key!r}: width {tier.width} != fact "
                    f"{fact}={want} — lane count and shape fact disagree; "
                    f"schedules would fan out over lanes that don't exist",
                    resource=key,
                ))

    if spec.derived_from is not None:
        if not spec.provenance:
            out.append(Finding(
                "spec.derived_provenance", ERROR, sub,
                f"derived from {spec.derived_from!r} but provenance is "
                f"empty — derivation must inherit where the constants "
                f"came from",
            ))
        missing = [k for k in ("n_gpus", "ppn") if k not in spec.facts]
        if missing:
            out.append(Finding(
                "spec.derived_facts", ERROR, sub,
                f"derived from {spec.derived_from!r} but lacks fact(s) "
                f"{missing} — elastic planning needs the surviving "
                f"participant count (shrink_spec records both)",
            ))
        else:
            n_gpus = int(spec.facts["n_gpus"])
            ppn = int(spec.facts["ppn"])
            inj = int(spec.facts.get("injectors_per_node", ppn))
            if not (n_gpus >= 1 and 1 <= ppn <= max(n_gpus, 1)):
                out.append(Finding(
                    "spec.derived_facts", ERROR, sub,
                    f"derived facts inconsistent: n_gpus={n_gpus}, "
                    f"ppn={ppn} (need n_gpus >= 1 and 1 <= ppn <= n_gpus)",
                ))
            elif ppn != inj:
                out.append(Finding(
                    "spec.derived_facts", ERROR, sub,
                    f"derived fact ppn={ppn} != injectors_per_node={inj} "
                    f"— injection caps would be priced for a different "
                    f"per-node injector count than the mesh runs",
                ))
    return out


def check_fit_residuals(
    spec: MachineSpec,
    measurements: Mapping[str, Iterable[Tuple[float, float]]],
    *,
    rel_tol: float = 0.5,
) -> List[Finding]:
    """Compare a fitted spec's tiers against the (size, seconds) samples
    they were fitted to; flag relative residuals beyond ``rel_tol``."""
    out: List[Finding] = []
    for tier_key, samples in measurements.items():
        try:
            tier = spec.tiers[tier_key]
        except KeyError:
            out.append(Finding(
                "spec.fit_missing_tier", WARNING, spec.name,
                f"measurements name tier {tier_key!r} the spec lacks",
                resource=tier_key,
            ))
            continue
        for s, t_meas in samples:
            t_model = float(tier.time(float(s)))
            if t_meas <= 0.0:
                continue
            rel = abs(t_model - t_meas) / t_meas
            if rel > rel_tol:
                out.append(Finding(
                    "spec.fit_residual", WARNING, spec.name,
                    f"tier {tier_key!r}: model {t_model:.3e}s vs measured "
                    f"{t_meas:.3e}s at {s:.0f} bytes "
                    f"({rel:.0%} relative residual)",
                    resource=tier_key,
                ))
    return out

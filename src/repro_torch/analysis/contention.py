"""Contention soundness: do composed schedules share what they physically share?

DESIGN.md §6.1's failure mode: one part names a tier's link lanes
``"dcn"`` (bare) while another names them ``"dcn.rank0"`` — the engine
merges resources *by name*, so the two parts silently model zero
contention on the same physical links.  Lockhart et al. 2022 show exactly
this class of optimistic model dominating real node-aware P2P apps.

Two checks, both static:

* **aliased pools** (error) — a bare tier-named resource coexists with a
  suffixed lane pool (``.rank{r}`` / ``.intra``) of the same tier in one
  schedule's resource set.  After the canonical-naming refactor nothing in
  the repo builds bare lane pools, so any occurrence is a composition of a
  pre-refactor (or hand-built) schedule that will under-price contention.
* **disjoint overlap** (warning) — two composed parts occupy lane pools of
  the same tier yet share zero resource names.  Legitimate when the parts
  model *different ranks'* lanes (``rank0`` vs ``rank1``); a smell when a
  representative-rank lowering was composed against a library schedule and
  they failed to merge.

Physical identity comes from :attr:`repro_torch.core.events.Resource.tier`
(populated by every builder); the name-parsing fallback handles schedules
assembled outside the builders.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Set

from repro_torch.core.events import Resource, Schedule

from repro_torch.analysis.findings import ERROR, WARNING, Finding

# suffixes the canonical naming scheme (DESIGN.md §6.1) attaches to a tier:
# lane pools price the tier's link lanes; engine/root are distinct hardware
# (copy/DMA engine, redistribution root core) and never alias the lanes.
_LANE_SUFFIX = re.compile(r"^(rank\d+|intra)$")
_UNIT_SUFFIX = re.compile(r"^(rank\d+|intra|engine|root)$")


def resource_tier(res: Resource) -> Optional[str]:
    """Physical tier this resource slices, or None for machine-wide pools
    (``cpu_cores``) and unrecognized names."""
    if res.tier is not None:
        return res.tier
    base, dot, suffix = res.name.rpartition(".")
    if dot and _UNIT_SUFFIX.match(suffix):
        return base
    return None


def _is_lane_pool(res: Resource) -> bool:
    """True for resources pricing a tier's link lanes (not engine/root)."""
    tier = resource_tier(res)
    if tier is None:
        return False
    if res.name == tier:
        return True  # bare tier name IS the lane pool, pre-refactor style
    base, dot, suffix = res.name.rpartition(".")
    return bool(dot) and base == tier and bool(_LANE_SUFFIX.match(suffix))


def _parts(schedule: Schedule) -> Dict[str, Set[str]]:
    """Per-part resource usage, recovered from compose's ``{part}#{i}/``
    step-name prefixes; a single-part schedule maps to one entry."""
    out: Dict[str, Set[str]] = {}
    for st in schedule.steps:
        prefix, slash, _ = st.name.partition("/")
        part = prefix if slash and "#" in prefix else ""
        out.setdefault(part, set()).update(st.resources)
    return out


def analyze_contention(schedule: Schedule) -> List[Finding]:
    """Aliasing and disjoint-overlap findings for one (maybe composed)
    schedule (empty list = sound)."""
    out: List[Finding] = []
    sub = schedule.name
    lane_pools = [
        r for r in schedule.resources.values() if _is_lane_pool(r)
    ]

    by_tier: Dict[str, List[Resource]] = {}
    for r in lane_pools:
        by_tier.setdefault(resource_tier(r), []).append(r)
    for tier, pools in by_tier.items():
        bare = [r for r in pools if r.name == tier]
        suffixed = [r for r in pools if r.name != tier]
        if bare and suffixed:
            out.append(Finding(
                "contention.aliased_pools", ERROR, sub,
                f"tier {tier!r}: bare pool {bare[0].name!r} and "
                f"{sorted(r.name for r in suffixed)} price the same "
                f"physical links under different names — composition "
                f"models zero contention between them",
                resource=bare[0].name,
            ))

    parts = _parts(schedule)
    if len(parts) > 1:
        lane_names = {r.name for r in lane_pools}
        part_lanes = {
            p: {r for r in res if r in lane_names}
            for p, res in parts.items()
        }
        tier_of = {
            r.name: resource_tier(r) for r in lane_pools
        }
        names = sorted(parts)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if part_lanes[a] & part_lanes[b]:
                    continue
                shared_tiers = (
                    {tier_of[r] for r in part_lanes[a]}
                    & {tier_of[r] for r in part_lanes[b]}
                )
                if shared_tiers:
                    out.append(Finding(
                        "contention.disjoint_overlap", WARNING, sub,
                        f"parts {a!r} and {b!r} both occupy lane pools of "
                        f"tier(s) {sorted(shared_tiers)} but share no "
                        f"resource — contention on those links is "
                        f"unmodeled (distinct ranks, or a naming split?)",
                    ))
    return out

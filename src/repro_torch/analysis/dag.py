"""Structural verification of a Schedule DAG — no engine run required.

Re-checks everything :class:`~repro_torch.core.events.Schedule.__post_init__`
enforces (the fuzzer builds broken schedules around the constructor, and
hand-assembled dicts of steps never went through it) and adds the graph
properties the constructor cannot see locally: cycles, steps unrunnable
because they sit downstream of a cycle, duplicate dep/resource listings,
non-finite prices, and release floors that can never bind.

Elango et al. 2014 frame data-movement lower bounds as properties of the
computation DAG itself; in the same spirit these checks prove the *shape*
is sound before any simulation prices it.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.core.events import Schedule, SimResult

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding

_TRANSFER_KINDS = ("send", "copy_d2h", "copy_h2d")


def _finite(v: float) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def verify_schedule(schedule: Schedule) -> List[Finding]:
    """All structural findings for one schedule (empty list = clean)."""
    out: List[Finding] = []
    sub = schedule.name
    names: Dict[str, int] = {}
    for st in schedule.steps:
        if st.name in names:
            out.append(Finding(
                "dag.duplicate_step", ERROR, sub,
                f"step name {st.name!r} declared more than once",
                step=st.name,
            ))
        names[st.name] = names.get(st.name, 0) + 1

    for st in schedule.steps:
        seen_deps = set()
        for d in st.deps:
            if d not in names:
                out.append(Finding(
                    "dag.dangling_dep", ERROR, sub,
                    f"step {st.name!r} depends on unknown step {d!r}",
                    step=st.name,
                ))
            elif d in seen_deps:
                out.append(Finding(
                    "dag.duplicate_dep", WARNING, sub,
                    f"step {st.name!r} lists dep {d!r} twice",
                    step=st.name,
                ))
            seen_deps.add(d)
        seen_res = set()
        for r in st.resources:
            if r not in schedule.resources:
                out.append(Finding(
                    "dag.unknown_resource", ERROR, sub,
                    f"step {st.name!r} occupies undeclared resource {r!r}",
                    step=st.name, resource=r,
                ))
            elif r in seen_res:
                out.append(Finding(
                    "dag.duplicate_resource", WARNING, sub,
                    f"step {st.name!r} occupies resource {r!r} twice "
                    f"(takes two slots of the same pool)",
                    step=st.name, resource=r,
                ))
            seen_res.add(r)

        for label, v in (
            ("duration", st.duration), ("release", st.release),
            ("alpha_time", st.alpha_time), ("beta_time", st.beta_time),
            ("nbytes", st.nbytes), ("n_msgs", st.n_msgs),
        ):
            if not _finite(v):
                out.append(Finding(
                    "dag.nonfinite", ERROR, sub,
                    f"step {st.name!r}: non-finite {label} ({v!r})",
                    step=st.name,
                ))
            elif v < 0:
                out.append(Finding(
                    "dag.negative", ERROR, sub,
                    f"step {st.name!r}: negative {label} ({v!r})",
                    step=st.name,
                ))
        if (
            _finite(st.nbytes) and st.nbytes == 0.0
            and st.kind in _TRANSFER_KINDS and st.duration > 0.0
        ):
            out.append(Finding(
                "dag.zero_bytes", WARNING, sub,
                f"step {st.name!r} ({st.kind}) takes {st.duration:.3e}s "
                f"but declares zero bytes — unpriced transfer?",
                step=st.name,
            ))
        if (
            _finite(st.alpha_time) and _finite(st.beta_time)
            and _finite(st.duration)
            and st.alpha_time + st.beta_time
                > st.duration * (1.0 + 1e-9) + 1e-15
        ):
            out.append(Finding(
                "dag.price_split", WARNING, sub,
                f"step {st.name!r}: alpha_time + beta_time "
                f"({st.alpha_time + st.beta_time:.3e}s) exceeds duration "
                f"({st.duration:.3e}s)",
                step=st.name,
            ))

    # release floor that can never bind: ready = max(release, dep ends),
    # and a dep with release >= ours ends no earlier than its own release
    by_name = {st.name: st for st in schedule.steps}
    for st in schedule.steps:
        if st.release > 0 and _finite(st.release) and any(
            d in by_name and by_name[d].release >= st.release
            for d in st.deps
        ):
            out.append(Finding(
                "dag.redundant_release", INFO, sub,
                f"step {st.name!r}: release {st.release:.3e}s can never "
                f"bind (a dep already releases at or after it)",
                step=st.name,
            ))

    used = {r for st in schedule.steps for r in st.resources}
    for rname in schedule.resources:
        if rname not in used:
            out.append(Finding(
                "dag.unused_resource", INFO, sub,
                f"resource {rname!r} is declared but no step occupies it",
                resource=rname,
            ))

    # Kahn toposort; whatever survives is in (or downstream of) a cycle.
    # Skip when deps dangle — indegrees would be wrong and the dangling-dep
    # errors above already gate.
    if not any(f.check == "dag.dangling_dep" for f in out):
        indeg = {st.name: len(set(st.deps)) for st in schedule.steps}
        dependents: Dict[str, List[str]] = {st.name: [] for st in schedule.steps}
        for st in schedule.steps:
            for d in set(st.deps):
                dependents[d].append(st.name)
        frontier = [n for n, k in indeg.items() if k == 0]
        done = 0
        while frontier:
            n = frontier.pop()
            done += 1
            for m in dependents[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    frontier.append(m)
        if done != len(indeg):
            stuck = sorted(n for n, k in indeg.items() if k > 0)
            out.append(Finding(
                "dag.cycle", ERROR, sub,
                f"dependency cycle leaves {len(stuck)} step(s) unrunnable: "
                f"{stuck[:8]}",
            ))
    return out


def verify_result(result: SimResult) -> List[Finding]:
    """Cross-check an engine run against the schedule's declared semantics.

    Not part of the static gate (it needs a run), but the same Finding
    vocabulary: trace timing must respect release/ready/duration, and no
    resource may ever hold more steps than its capacity — an independent
    audit of the engine's slot accounting built from the blocker metadata.
    """
    out: List[Finding] = []
    sub = result.schedule.name
    for t in result.traces.values():
        if t.end - t.start != t.step.duration and not math.isclose(
            t.end - t.start, t.step.duration, rel_tol=1e-12, abs_tol=1e-15
        ):
            out.append(Finding(
                "run.duration", ERROR, sub,
                f"step {t.step.name!r}: trace span {t.end - t.start:.3e}s "
                f"!= declared duration {t.step.duration:.3e}s",
                step=t.step.name,
            ))
        if t.start < t.ready or t.ready < t.step.release:
            out.append(Finding(
                "run.ready_order", ERROR, sub,
                f"step {t.step.name!r}: start {t.start:.3e} < ready "
                f"{t.ready:.3e} or ready < release {t.step.release:.3e}",
                step=t.step.name,
            ))
    # sweep-line occupancy audit per resource
    for rname, res in result.schedule.resources.items():
        events = []
        for t in result.traces.values():
            if rname in t.step.resources and t.end > t.start:
                events.append((t.start, 1))
                events.append((t.end, -1))
        events.sort()
        level = peak = 0
        for _, delta in events:
            level += delta
            peak = max(peak, level)
        if peak > res.capacity:
            out.append(Finding(
                "run.overcommit", ERROR, sub,
                f"resource {rname!r}: {peak} concurrent holders exceed "
                f"capacity {res.capacity}",
                resource=rname,
            ))
    return out

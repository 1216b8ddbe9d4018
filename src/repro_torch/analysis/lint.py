"""``python -m repro_torch.analysis.lint`` — sweep machines × schedules, report JSON.

For every requested registry machine this builds the full schedule surface
— every declared strategy lowering (eager and rendezvous sizes, with and
without message splitting), every library collective, the TPU composed
lowerings (hierarchical / flat-ring / MoE / EP dispatch), and a
cross-family composition (lowered strategy overlapped with a library
schedule on the same tier) — and runs the static verifiers on each:
DAG structure, byte conservation, contention soundness, plus the spec
linter on the machine itself.

Exit status is 0 iff no error- or warning-severity findings exist; info
findings (the paper tables' known locality-ordering quirks, the one
``suspect`` Lassen segment) are reported under ``notes`` and never gate.
The CI ``simlint`` job runs ``--all --json`` and uploads the report.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import (
    ERROR,
    Finding,
    WARNING,
    check_collective,
    check_lowering,
    check_node_aware,
    lint_spec,
    sort_findings,
    verify,
)
from repro_torch.core.machine import MachineSpec, get_machine, registered_machines
from repro_torch.core.schedule import (
    bruck_alltoall_schedule,
    compose_schedules,
    ep_dispatch_schedules,
    flat_ring_allreduce_schedule,
    hierarchical_allreduce_schedule,
    lower_strategy,
    moe_alltoall_schedules,
    node_aware_alltoall_schedule,
    recursive_doubling_allgather_schedule,
    recursive_halving_reduce_scatter_schedule,
    ring_allgather_schedule,
    ring_allreduce_schedule,
    ring_reduce_scatter_schedule,
)

# (nbytes_per_msg, n_msgs): one eager-protocol size, one rendezvous size
_LOWERING_SIZES: Tuple[Tuple[float, float], ...] = (
    (4096.0, 4.0),
    (float(1 << 20), 32.0),
)
_LIB_BYTES = float(1 << 20)
_LIB_RANKS = 8


def _spec_for(name: str) -> Tuple[MachineSpec, Optional[object]]:
    """Registry spec plus, for topology-factories, a multi-pod topology so
    the DCN paths are exercised."""
    if name == "tpu_v5e":
        from repro_torch.core.topology import TpuPodTopology

        topo = TpuPodTopology(pods=2)
        return get_machine(name, topo=topo), topo
    return get_machine(name), None


def _lint_lowerings(spec: MachineSpec, acc: List[Finding], count: List[int]) -> None:
    for strat in spec.strategies:
        for s, n in _LOWERING_SIZES:
            for split in (False, True):
                sched = lower_strategy(
                    spec, strat, s, n, split_messages=split,
                )
                acc += verify(sched)
                acc += check_lowering(
                    spec, strat, sched, s, n, split_messages=split,
                )
                count[0] += 1


def _lint_library(spec: MachineSpec, tier: str, acc: List[Finding],
                  count: List[int], *, ppn: float = 1.0) -> None:
    p, B = _LIB_RANKS, _LIB_BYTES
    cases = (
        (ring_allreduce_schedule(spec, tier, p, B, ppn=ppn),
         "ring_allreduce", 2),
        (ring_reduce_scatter_schedule(spec, tier, p, B, ppn=ppn),
         "ring_reduce_scatter", 2),
        (ring_allgather_schedule(spec, tier, p, B, ppn=ppn),
         "ring_allgather", 1),
        (recursive_doubling_allgather_schedule(spec, tier, p, B),
         "recursive_doubling_allgather", 1),
        (recursive_halving_reduce_scatter_schedule(spec, tier, p, B),
         "recursive_halving_reduce_scatter", 1),
        (bruck_alltoall_schedule(spec, tier, p, B, ppn=ppn),
         "bruck_alltoall", 1),
    )
    for sched, collective, directions in cases:
        acc += verify(sched)
        acc += check_collective(
            sched, collective, p, B, directions=directions,
        )
        count[0] += 1


def _lint_cross_family(spec: MachineSpec, strat: str, tier: str,
                       acc: List[Finding], count: List[int]) -> None:
    """Lowered strategy + library schedule on the same tier: after the
    §6.1 canonical-naming refactor they must merge onto shared pools
    (a disjoint-overlap finding here is the exact regression gate)."""
    s, n = _LOWERING_SIZES[1]
    lowered = lower_strategy(spec, strat, s, n)
    lib = ring_allgather_schedule(spec, tier, _LIB_RANKS, _LIB_BYTES)
    composed = compose_schedules(spec, [lowered, lib])
    acc += verify(composed)
    shared = set(lowered.resources) & set(lib.resources)
    if not shared:
        acc.append(Finding(
            "contention.cross_family_merge", ERROR, composed.name,
            f"lowered {strat!r} and {lib.name!r} on tier {tier!r} share "
            f"no resource pool — the §6.1 merge regressed",
        ))
    count[0] += 1


def lint_machine(name: str) -> Dict[str, object]:
    """Full sweep for one registry machine; returns the per-machine report."""
    spec, topo = _spec_for(name)
    acc: List[Finding] = list(lint_spec(spec))
    count = [0]

    _lint_lowerings(spec, acc, count)

    if topo is None:
        _lint_library(spec, "gpu_net", acc, count)
        g = int(spec.fact("gpus_per_node", 1))
        if g > 1:
            na = node_aware_alltoall_schedule(
                spec, _LIB_BYTES, 4 * g, ranks_per_node=g,
            )
            acc += verify(na)
            acc += check_node_aware(na, g, 4, _LIB_BYTES)
            count[0] += 1
        _lint_cross_family(spec, "cuda_aware", "gpu_net", acc, count)
    else:
        _lint_library(spec, "ici", acc, count)
        for sched in (
            hierarchical_allreduce_schedule(topo, _LIB_BYTES),
            flat_ring_allreduce_schedule(topo, _LIB_BYTES),
        ):
            acc += verify(sched)
            count[0] += 1
        E = 8
        moe = moe_alltoall_schedules(topo, _LIB_BYTES, E)
        for key, collective in (
            ("direct_a2a", "moe_direct"), ("tree_a2a", "moe_tree"),
        ):
            acc += verify(moe[key])
            acc += check_collective(moe[key], collective, E, _LIB_BYTES)
            count[0] += 1
        ep = ep_dispatch_schedules(spec, _LIB_BYTES, (4, 4))
        s_total = _LIB_BYTES * 16
        for key, collective in (
            ("direct", "ep_direct"), ("hierarchical", "ep_hierarchical"),
        ):
            acc += verify(ep[key])
            acc += check_collective(ep[key], collective, 16, s_total)
            count[0] += 1
        _lint_cross_family(spec, "direct", "dcn", acc, count)

    acc = sort_findings(acc)
    return {
        "machine": name,
        "schedules_checked": count[0],
        "findings": [
            f.to_dict() for f in acc if f.severity in (ERROR, WARNING)
        ],
        "notes": [
            f.to_dict() for f in acc
            if f.severity not in (ERROR, WARNING)
        ],
    }


def lint_all(machines: Optional[List[str]] = None) -> Dict[str, object]:
    names = list(machines) if machines else list(registered_machines())
    per_machine = [lint_machine(name) for name in names]
    findings = [f for m in per_machine for f in m["findings"]]
    return {
        "tool": "repro_torch.analysis.lint",
        "machines": per_machine,
        "schedules_checked": sum(m["schedules_checked"] for m in per_machine),
        "finding_count": len(findings),
        "note_count": sum(len(m["notes"]) for m in per_machine),
        "clean": not findings,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static schedule/spec verifier (simlint)",
    )
    ap.add_argument("--all", action="store_true",
                    help="sweep every registered machine")
    ap.add_argument("--machine", action="append", default=[],
                    help="lint one machine (repeatable)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the findings report as JSON")
    ap.add_argument("--show-notes", action="store_true",
                    help="print info-severity notes too")
    args = ap.parse_args(argv)
    if not args.all and not args.machine:
        ap.error("pass --all or --machine NAME")

    report = lint_all(args.machine or None)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    for m in report["machines"]:
        status = "clean" if not m["findings"] else (
            f"{len(m['findings'])} finding(s)"
        )
        print(f"{m['machine']}: {m['schedules_checked']} schedules checked, "
              f"{status}, {len(m['notes'])} note(s)")
        for f in m["findings"]:
            print(f"  [{f['severity']}] {f['check']}: {f['detail']}")
        if args.show_notes:
            for f in m["notes"]:
                print(f"  [{f['severity']}] {f['check']}: {f['detail']}")
    print(f"total: {report['schedules_checked']} schedules, "
          f"{report['finding_count']} finding(s), "
          f"{report['note_count']} note(s)")
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())

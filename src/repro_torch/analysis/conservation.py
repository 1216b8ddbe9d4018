"""Byte conservation: does a schedule move the bytes its semantics demand?

Two independent recomputations, both static (no engine run):

* :func:`check_collective` — library schedules against the collective's
  closed-form per-rank byte count.  A ring all-reduce of B bytes over p
  ranks must send 2·(p-1)/p·B per rank; an all-gather is size-multiplying
  ((p-1)·B per rank); an all-to-all conserves totals.  Schedules account
  bytes *per direction lane* (a bidirectional ring's round step carries
  the per-direction chunk), so declared sums are compared at
  ``physical / directions`` and additionally gated against the
  direction-independent conservation minimum.
* :func:`check_lowering` — ``lower_strategy`` output against an
  independent re-derivation of each :class:`~repro_torch.core.machine.Traversal`
  declaration's stage totals (msgs/bulk/redist lane splitting, byte
  scales, dedup).  The arithmetic intentionally duplicates
  ``lower_path``'s byte plumbing so a regression there (a lost ``scale``,
  a double-applied lane split) shows up as a conservation error, not a
  silently wrong simulation.

Tolerance is 1e-9 relative — these are closed-form identities, not fits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.core.events import Schedule
from repro_torch.core.machine import MachineSpec

from repro_torch.analysis.findings import ERROR, Finding

_REL_TOL = 1e-9

# transfer step kinds that move payload across a tier (stage = staged copy /
# redistribution hop; it still moves the bytes it declares)
TRANSFER_KINDS = ("send", "reduce", "copy_d2h", "copy_h2d", "stage")


def declared_bytes(schedule: Schedule) -> float:
    """Sum of declared step payloads over all transfer steps."""
    return sum(
        st.nbytes for st in schedule.steps if st.kind in TRANSFER_KINDS
    )


def collective_bytes(
    collective: str,
    p: int,
    bytes_per_rank: float,
    *,
    directions: int = 1,
) -> Tuple[float, float]:
    """(expected declared per-rank bytes, conservation minimum) closed forms.

    The first element is what the library builder should have declared
    (per-direction accounting); the second the physical lower bound the
    collective's semantics demand per rank, divided by ``directions`` so
    both are in declared units.
    """
    B = float(bytes_per_rank)
    k = int(p)
    d = float(directions)
    if k <= 1:
        return 0.0, 0.0
    log2k = int(math.ceil(math.log2(k)))
    if collective == "ring_allreduce":
        exact = 2 * (k - 1) * B / (k * d)
        return exact, exact
    if collective == "ring_reduce_scatter":
        exact = (k - 1) * B / (k * d)
        return exact, exact
    if collective == "ring_allgather":
        exact = (k - 1) * B / d
        return exact, exact
    if collective == "recursive_doubling_allgather":
        # blocks 1, 2, ... clamped at k - gathered telescope to k-1
        return (k - 1) * B, (k - 1) * B
    if collective == "recursive_halving_reduce_scatter":
        # halving r times moves B(1 - 2^-r) >= the (k-1)/k·B minimum
        exact = B * (1.0 - 0.5 ** log2k)
        return exact, (k - 1) * B / k
    if collective == "bruck_alltoall":
        # each of ceil(log2 k) rounds forwards ceil(k/2) blocks of B:
        # latency-optimal, bandwidth-inflated over the (k-1)·B direct floor
        exact = log2k * math.ceil(k / 2) * B
        return exact, (k - 1) * B
    if collective == "moe_direct":
        # payload B split across k-1 peers: conserved exactly
        return B, B * (k - 1) / k
    if collective == "moe_tree":
        # ceil(log2 k) neighbour rounds of B/2 (Bruck-style inflation)
        return log2k * B / 2, B * (k - 1) / k
    if collective == "ep_direct":
        # one hop moving the full bucket payload once
        return B, B * (k - 1) / k
    if collective == "ep_hierarchical":
        # two hops (intra then inter): every byte crosses the tier twice
        return 2 * B, B * (k - 1) / k
    raise ValueError(f"unknown collective {collective!r}")


def check_collective(
    schedule: Schedule,
    collective: str,
    p: int,
    bytes_per_rank: float,
    *,
    directions: int = 1,
    ranks: int = 1,
) -> List[Finding]:
    """Compare a library schedule's declared bytes to the closed forms."""
    out: List[Finding] = []
    expected, minimum = collective_bytes(
        collective, p, bytes_per_rank, directions=directions,
    )
    declared = declared_bytes(schedule) / max(int(ranks), 1)
    scale = max(abs(expected), abs(declared), 1e-30)
    if abs(declared - expected) > _REL_TOL * scale:
        out.append(Finding(
            "conservation.collective_bytes", ERROR, schedule.name,
            f"{collective}[p={p}, B={bytes_per_rank:.0f}, "
            f"directions={directions}]: declares {declared:.6e} bytes/rank, "
            f"closed form says {expected:.6e}",
        ))
    if declared < minimum * (1.0 - _REL_TOL):
        out.append(Finding(
            "conservation.lower_bound", ERROR, schedule.name,
            f"{collective}[p={p}]: declares {declared:.6e} bytes/rank, "
            f"below the {minimum:.6e} the collective's semantics require "
            f"— bytes are being lost, not moved",
        ))
    return out


def check_node_aware(
    schedule: Schedule,
    g: int,
    n_nodes: int,
    msg_bytes: float,
) -> List[Finding]:
    """Node-aware two-level all-to-all (Lockhart et al. 2022) conservation.

    The inter-node phase must move exactly the off-node bytes a direct
    all-to-all would — g ranks each sending (N-1) aggregated messages of
    g·s, totalling g²·(N-1)·s per node — and each on-node redistribution
    phase moves (g-1)·(N-1)·s per rank.  Aggregation may cut *messages*,
    never bytes.
    """
    out: List[Finding] = []
    s = float(msg_bytes)
    N = max(int(n_nodes), 1)
    inter_declared = sum(
        st.nbytes for st in schedule.steps
        if st.kind in TRANSFER_KINDS and st.name.startswith("inter.")
    )
    intra_declared = sum(
        st.nbytes for st in schedule.steps
        if st.kind in TRANSFER_KINDS and not st.name.startswith("inter.")
    )
    inter_expected = g * max(N - 1, 0) * g * s
    intra_expected = 2 * g * max(g - 1, 0) * max(N - 1, 0) * s
    for phase, got, expected in (
        ("inter", inter_declared, inter_expected),
        ("intra", intra_declared, intra_expected),
    ):
        ref = max(abs(expected), abs(got), 1e-30)
        if abs(got - expected) > _REL_TOL * ref:
            out.append(Finding(
                "conservation.node_aware_bytes", ERROR, schedule.name,
                f"node_aware_alltoall[g={g}, nodes={N}, s={s:.0f}] "
                f"{phase} phase declares {got:.6e} bytes, semantics "
                f"require {expected:.6e}",
            ))
    return out


def _stage_totals(schedule: Schedule) -> Dict[int, float]:
    """Declared bytes per lowering stage, keyed by the ``s{i}.`` step
    prefix ``lower_path`` emits."""
    totals: Dict[int, float] = {}
    for st in schedule.steps:
        if not st.name.startswith("s"):
            continue
        head = st.name.split(".", 1)[0]
        if not head[1:].isdigit():
            continue
        si = int(head[1:])
        totals[si] = totals.get(si, 0.0) + st.nbytes
    return totals


def check_lowering(
    spec: MachineSpec,
    strategy: str,
    schedule: Schedule,
    nbytes_per_msg: float,
    n_msgs: float = 1,
    *,
    dedup_factor: float = 1.0,
    split_messages: bool = False,
) -> List[Finding]:
    """Compare a lowered strategy's per-stage bytes to the Traversal
    declarations, re-derived independently of ``lower_path``."""
    out: List[Finding] = []
    decl = spec.strategies[strategy]
    path = spec.path(decl.path)
    lanes = int(spec.value(decl.lanes, default=1))
    s = float(nbytes_per_msg)
    n = float(n_msgs)
    totals = _stage_totals(schedule)

    for si, trav in enumerate(path.steps):
        L = int(spec.value(trav.lanes, default=lanes))
        scale = float(spec.value(trav.byte_scale, default=1.0))
        if trav.kind == "msgs":
            s_eff = (s / L if L != 1 else s) * scale
            n_eff = max(n / L, 1.0) if (trav.split_msgs and split_messages) else n
            expected = L * n_eff * s_eff
        elif trav.kind == "bulk":
            expected = s * n * scale
            if trav.dedup:
                expected *= dedup_factor
        elif trav.kind == "redist":
            expected = (L - 1) * (s * n * scale) / L
        else:
            continue
        got = totals.get(si, 0.0)
        ref = max(abs(expected), abs(got), 1e-30)
        if abs(got - expected) > _REL_TOL * ref:
            out.append(Finding(
                "conservation.lowering_bytes", ERROR, schedule.name,
                f"{spec.name}:{strategy} stage {si} ({trav.tier}, "
                f"{trav.kind}): schedule declares {got:.6e} bytes, the "
                f"Traversal declaration implies {expected:.6e} "
                f"(s={s:.0f}, n={n:.0f}, lanes={L}, scale={scale})",
            ))
    return out

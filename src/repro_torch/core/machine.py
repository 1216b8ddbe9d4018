"""Declarative machine descriptions: transport tiers, paths, and a registry.

The paper's observation (and this module's organizing idea) is that *every*
inter-device communication path — GPUDirect, the 3-step copy-to-CPU path,
the all-cores variants, TPU ICI/DCN staging — is the same algebra:

  * a :class:`TransportTier` is one segmented postal model (Eq. 1) plus an
    optional node-aggregate injection cap ``beta_N`` (Eq. 2, Table III), a
    parallelism ``width`` (CPU cores per GPU, hosts per pod, ICI links), and
    copy-engine serialization behaviour (DESIGN.md §2.2);
  * a :class:`Path` is an explicit composition of tier traversals
    (3-step = ``copy_d2h -> cpu_net -> copy_h2d``; TPU staged =
    ``ici -> dcn -> ici``), each traversal saying how the payload maps onto
    the tier (per-message, bulk, or redistribution);
  * a :class:`MachineSpec` names the tiers, paths, collective strategies and
    shape facts of one machine, and a module-level registry
    (:func:`register_machine` / :func:`get_machine`) makes specs addressable
    by name — whether they came from the paper's tables (``summit``,
    ``lassen``), from target constants (``tpu_v5e``, ``gh200``), or from a
    live fit (:func:`repro_torch.core.benchmark.spec_from_measurements`).

``core/paths.py``, ``core/simulate.py`` and ``core/planner.py`` are written
against this vocabulary only; they contain no per-machine branching.  The
generic evaluators here reproduce the pre-registry implementations bit-for-
bit (tests/test_machine.py pins equality and the Fig 5 crossovers).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core.maxrate import MaxRateParams
from repro_torch.core.params import (
    CopyDirection,
    Locality,
    MACHINES,
    PostalParams,
    TABLE_I,
    TABLE_II,
    TABLE_III_BETA_N,
)
from repro_torch.core.postal import SimplePostalModel, paper_model

# A fact reference: literal value, or a key into MachineSpec.facts, or None
# (meaning "use the call-time default").
FactRef = Union[int, float, str, None]


# --------------------------------------------------------------------------
# Tiers.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransportTier:
    """One transport resource: postal model + injection cap + parallelism.

    ``model`` is any postal model exposing ``time(nbytes)`` and
    ``params_for(nbytes) -> PostalParams`` (segmented or single-segment).
    ``beta_N`` is the node-aggregate injection cost (s/B, Table III); None
    means the cap is never reached.  ``width`` is the number of parallel
    lanes the tier offers (CPU cores per GPU, hosts per pod, ICI links per
    chip).  ``serialize_alpha`` marks single-engine tiers (the copy/DMA
    engine): concurrent operations serialize their launch latency while the
    bandwidth term sees the payload once (DESIGN.md §2.2).
    """

    name: str
    model: object
    beta_N: Optional[float] = None
    width: int = 1
    serialize_alpha: bool = False

    def params_for(self, nbytes: float) -> PostalParams:
        return self.model.params_for(nbytes)

    def maxrate(self, nbytes: float) -> MaxRateParams:
        p = self.params_for(nbytes)
        return MaxRateParams(p.alpha, p.beta, self.beta_N)

    def postal_terms(self, nbytes: float, ppn: float = 1.0) -> Tuple[float, float, bool]:
        """(alpha, effective beta, cap_bound) at one size with ppn injectors.

        The scalar form of :func:`_capped_beta` — the schedule compiler
        (:mod:`repro_torch.core.schedule`) prices steps with it so the event engine
        and the closed-form evaluators agree bit-for-bit on uncontended runs.
        """
        p = self.params_for(float(nbytes))
        if self.beta_N is None:
            return p.alpha, p.beta, False
        capped = float(ppn) * self.beta_N
        if capped > p.beta:
            return p.alpha, capped, True
        return p.alpha, p.beta, False

    def time(self, nbytes) -> np.ndarray:
        return self.model.time(nbytes)


# --------------------------------------------------------------------------
# Paths: compositions of tier traversals.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Traversal:
    """One step of a path: how the payload crosses one tier.

    kind:
      * ``"msgs"``   — each of ``n`` messages crosses the tier; bytes split
                       over the active lanes (protocol segment chosen at the
                       per-lane size, paper Eq. 3).
      * ``"bulk"``   — the union of the payload crosses once (memcpy of the
                       gathered buffer, single DCN stream, ICI gather).
      * ``"redist"`` — on-node redistribution: ``lanes - 1`` messages of
                       ``total / lanes`` (the Extra-Msg scatter/gather).

    ``lanes``/``ppn``/``byte_scale`` accept literals or fact names; ``lanes``
    of None resolves to the call-time lane count (the planner sweeps it).
    ``ppn`` of None resolves to ``lanes * concurrency``.  ``alpha_extra`` is
    additive latency (multi-hop ICI).  ``split_msgs`` allows the message
    count itself to split over lanes when the pattern permits (Alltoallv).
    ``dedup`` applies the call-time dedup factor (bulk copies of duplicated
    bytes).  ``serialize`` engages the tier's copy-engine serialization.
    """

    tier: str
    kind: str = "msgs"
    locality: Optional[Locality] = None
    lanes: FactRef = None
    ppn: FactRef = None
    byte_scale: FactRef = 1.0
    alpha_extra: float = 0.0
    split_msgs: bool = False
    dedup: bool = False
    serialize: bool = False


@dataclasses.dataclass(frozen=True)
class Path:
    name: str
    steps: Tuple[Traversal, ...]
    description: str = ""


@dataclasses.dataclass(frozen=True)
class StrategyDecl:
    """A named way to run a collective: a path plus its fixed lane count."""

    path: str
    lanes: FactRef = 1


# --------------------------------------------------------------------------
# MachineSpec.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """A machine as the planner sees it: tiers, paths, strategies, facts.

    ``tiers`` keys may be locality-qualified (``"cpu_net:off-node"``) or
    socket-qualified (``"copy_d2h:on-socket"``); :meth:`resolve_tier` picks
    the most specific entry for a traversal.  ``facts`` holds shape numbers
    (gpus_per_node, cores_per_gpu, hosts_per_pod, ...) that traversals and
    strategy declarations reference by name.  ``plan_variants`` are the
    candidates message-level planning ranks; ``strategies`` the collective
    strategies the simulator ranks; ``crossover_paths`` the (direct, staged)
    pair whose Fig-5 message-count crossover the planner reports.
    """

    name: str
    tiers: Mapping[str, TransportTier]
    paths: Mapping[str, Path]
    strategies: Mapping[str, StrategyDecl] = dataclasses.field(default_factory=dict)
    plan_variants: Mapping[str, StrategyDecl] = dataclasses.field(default_factory=dict)
    facts: Mapping[str, float] = dataclasses.field(default_factory=dict)
    crossover_paths: Tuple[str, str] = ("gpudirect", "three_step")
    description: str = ""
    # where the tier constants came from: "measured" (paper tables / live
    # benchmark), "representative" (plausible figures, no hardware behind
    # them), or "fitted" (spec_from_measurements / congestion refits).
    # Deliberately NOT part of the fingerprint — provenance is metadata
    # about the numbers, not a number the planner consumes, so tagging a
    # spec must not invalidate its cached plans.
    provenance: str = "measured"
    # name of the spec this one was derived from (shrink_spec, health
    # refits); like provenance it is lineage metadata, excluded from the
    # fingerprint — the *derived facts/widths* are what change plans.
    derived_from: Optional[str] = None

    def fact(self, key: str, default: Optional[float] = None) -> float:
        if key in self.facts:
            return self.facts[key]
        if default is None:
            raise KeyError(f"machine {self.name!r} has no fact {key!r}")
        return default

    def value(self, ref: FactRef, default: Union[int, float] = 1) -> float:
        """Resolve a literal-or-fact-name reference."""
        if ref is None:
            return default
        if isinstance(ref, str):
            return self.fact(ref)
        return ref

    def resolve_tier(
        self,
        name: str,
        locality: Locality = Locality.OFF_NODE,
        socket: str = "on-socket",
    ) -> TransportTier:
        for key in (f"{name}:{locality.value}", f"{name}:{socket}", name):
            tier = self.tiers.get(key)
            if tier is not None:
                return tier
        raise KeyError(f"machine {self.name!r} has no tier {name!r} "
                       f"(locality={locality.value}, socket={socket})")

    def path(self, name_or_path: Union[str, Path]) -> Path:
        if isinstance(name_or_path, Path):
            return name_or_path
        return self.paths[name_or_path]

    @property
    def fingerprint(self) -> str:
        """Structural digest of everything that affects planning decisions.

        Two specs with equal fingerprints lower to identical schedules and
        make identical plan picks, so the fingerprint (not ``name``) is the
        cache key for lowering memoization (:mod:`repro_torch.core.schedule`) and
        the plan cache (:mod:`repro_torch.comms.autotune`).  Live-fitted machines
        from ``spec_from_measurements`` reuse a registry name but carry new
        postal parameters — their fingerprints differ, so re-registering a
        refit spec can never serve a stale cached plan.

        Computed once per spec instance and memoized (frozen dataclasses
        still have a ``__dict__``, so ``object.__setattr__`` is legal).
        """
        cached = self.__dict__.get("_fingerprint")
        if cached is None:
            payload = repr((
                self.name,
                tuple(sorted(self.facts.items())),
                tuple(sorted(
                    (k, v.path, v.lanes) for k, v in self.strategies.items()
                )),
                tuple(sorted(
                    (k, v.path, v.lanes) for k, v in self.plan_variants.items()
                )),
                tuple(sorted(
                    (k, _path_signature(p)) for k, p in self.paths.items()
                )),
                tuple(sorted(
                    (k, _tier_signature(t)) for k, t in self.tiers.items()
                )),
                self.crossover_paths,
            ))
            cached = hashlib.sha1(payload.encode()).hexdigest()
            object.__setattr__(self, "_fingerprint", cached)
        return cached


def _path_signature(path: Path) -> tuple:
    return tuple(
        (t.tier, t.kind, None if t.locality is None else t.locality.value,
         t.lanes, t.ppn, t.byte_scale, t.alpha_extra, t.split_msgs,
         t.dedup, t.serialize)
        for t in path.steps
    )


# sizes at which an unknown fitted model is probed for its fingerprint: one
# per decade across the byte range the planner sweeps, hitting every
# protocol segment any realistic threshold layout can produce
_PROBE_SIZES = (0.0, float(1 << 10), float(1 << 14), float(1 << 18),
                float(1 << 22), float(1 << 26))


def _model_signature(model: object) -> tuple:
    if isinstance(model, SimplePostalModel):
        return ("simple", model.params.alpha, model.params.beta)
    segments = getattr(model, "segments", None)
    if segments is not None:
        return (
            "segmented",
            tuple(sorted(
                (proto.value, p.alpha, p.beta) for proto, p in segments.items()
            )),
            getattr(model, "short_max", None),
            getattr(model, "eager_max", None),
        )
    # unknown model type: characterize it by its parameters at a size ladder
    return ("probed", tuple(
        (s, model.params_for(s).alpha, model.params_for(s).beta)
        for s in _PROBE_SIZES
    ))


def _tier_signature(tier: TransportTier) -> tuple:
    return (tier.name, tier.beta_N, tier.width, tier.serialize_alpha,
            _model_signature(tier.model))


# --------------------------------------------------------------------------
# Generic evaluation.
# --------------------------------------------------------------------------

def _segment_arrays(tier: TransportTier, sizes: np.ndarray):
    """(alpha, beta) arrays with the protocol segment chosen per size."""
    uniq, inv = np.unique(sizes, return_inverse=True)
    alphas = np.empty(uniq.shape)
    betas = np.empty(uniq.shape)
    for i, v in enumerate(uniq.flat):
        p = tier.params_for(float(v))
        alphas.flat[i] = p.alpha
        betas.flat[i] = p.beta
    return alphas[inv].reshape(sizes.shape), betas[inv].reshape(sizes.shape)


def _capped_beta(tier: TransportTier, beta: np.ndarray, ppn) -> np.ndarray:
    if tier.beta_N is None:
        return beta
    return np.maximum(np.asarray(ppn, np.float64) * tier.beta_N, beta)


def traversal_time(
    spec: MachineSpec,
    trav: Traversal,
    nbytes_per_msg,
    n_msgs,
    *,
    lanes: int = 1,
    concurrency: int = 1,
    locality: Locality = Locality.OFF_NODE,
    socket: str = "on-socket",
    dedup_factor: float = 1.0,
    split_messages: bool = False,
) -> np.ndarray:
    """Time for (broadcastable) per-message bytes x message counts to cross
    one tier, per the traversal's payload mapping."""
    s = np.asarray(nbytes_per_msg, np.float64)
    n = np.asarray(n_msgs, np.float64)
    tier = spec.resolve_tier(trav.tier, trav.locality or locality, socket)
    lanes_eff = int(spec.value(trav.lanes, default=lanes))
    scale = float(spec.value(trav.byte_scale, default=1.0))

    if trav.kind == "msgs":
        s_eff = s / lanes_eff if lanes_eff != 1 else s
        if scale != 1.0:
            s_eff = s_eff * scale
        if trav.split_msgs and split_messages:
            n_eff = np.maximum(n / lanes_eff, 1.0)
        else:
            n_eff = n
        ppn = spec.value(trav.ppn, default=lanes_eff * concurrency)
        alpha, beta = _segment_arrays(tier, s_eff)
        alpha = alpha + trav.alpha_extra if trav.alpha_extra else alpha
        return alpha * n_eff + _capped_beta(tier, beta, ppn) * (n_eff * s_eff)

    if trav.kind == "bulk":
        total = s * n
        if scale != 1.0:
            total = total * scale
        if trav.dedup:
            total = total * dedup_factor
        if trav.serialize and tier.serialize_alpha and lanes_eff > 1:
            # lanes concurrent ops on one engine: launch latency serializes,
            # bandwidth sees the payload once (DESIGN.md §2.2).
            t0 = tier.time(0.0)
            return lanes_eff * t0 + (tier.time(total) - t0)
        share = total / lanes_eff if lanes_eff != 1 else total
        ppn = spec.value(trav.ppn, default=lanes_eff * concurrency)
        alpha, beta = _segment_arrays(tier, share)
        if trav.alpha_extra:
            alpha = alpha + trav.alpha_extra
        return alpha * 1.0 + _capped_beta(tier, beta, ppn) * (1.0 * share)

    if trav.kind == "redist":
        total = s * n
        if scale != 1.0:
            total = total * scale
        share = total / lanes_eff
        n_eff = float(lanes_eff - 1)
        ppn = spec.value(trav.ppn, default=lanes_eff * concurrency)
        alpha, beta = _segment_arrays(tier, share)
        if trav.alpha_extra:
            alpha = alpha + trav.alpha_extra
        return alpha * n_eff + _capped_beta(tier, beta, ppn) * (n_eff * share)

    raise ValueError(f"unknown traversal kind {trav.kind!r}")


def path_time(
    spec: MachineSpec,
    path: Union[str, Path],
    nbytes_per_msg,
    n_msgs=1,
    *,
    lanes: int = 1,
    concurrency: int = 1,
    locality: Locality = Locality.OFF_NODE,
    socket: str = "on-socket",
    dedup_factor: float = 1.0,
    split_messages: bool = False,
) -> np.ndarray:
    """Generic path cost: the sum of its tier traversals (paper §III-§V).

    Broadcasts over ``nbytes_per_msg`` x ``n_msgs`` like the postal models.
    ``lanes`` is the lane count traversals with unpinned lanes use (the
    planner sweeps 1..cores_per_gpu); ``concurrency`` the number of
    same-node injectors (GPUs per node) multiplying into the cap's ppn.
    """
    p = spec.path(path)
    s_b, n_b = np.broadcast_arrays(
        np.asarray(nbytes_per_msg, np.float64), np.asarray(n_msgs, np.float64)
    )
    out = np.zeros(s_b.shape, np.float64)
    for trav in p.steps:
        out = out + traversal_time(
            spec, trav, s_b, n_b,
            lanes=lanes, concurrency=concurrency, locality=locality,
            socket=socket, dedup_factor=dedup_factor,
            split_messages=split_messages,
        )
    return out if out.shape else np.float64(out)


def strategy_time(
    spec: MachineSpec,
    strategy: str,
    nbytes_per_msg,
    n_msgs=1,
    *,
    concurrency: Optional[int] = None,
    locality: Locality = Locality.OFF_NODE,
    socket: str = "on-socket",
    dedup_factor: float = 1.0,
    split_messages: bool = False,
) -> np.ndarray:
    """Cost of one declared collective strategy (its path at its lanes)."""
    decl = spec.strategies[strategy]
    conc = int(spec.fact("injectors_per_node", 1)) if concurrency is None else concurrency
    return path_time(
        spec, decl.path, nbytes_per_msg, n_msgs,
        lanes=int(spec.value(decl.lanes, default=1)), concurrency=conc,
        locality=locality, socket=socket, dedup_factor=dedup_factor,
        split_messages=split_messages,
    )


def simulate_strategies(
    spec: MachineSpec, nbytes_per_msg, n_msgs=1, **kwargs
) -> Dict[str, float]:
    """Every declared strategy's cost — the generic §VI simulator."""
    return {
        name: float(strategy_time(spec, name, nbytes_per_msg, n_msgs, **kwargs))
        for name in spec.strategies
    }


def plan_costs(
    spec: MachineSpec, nbytes_per_msg, n_msgs=1, **kwargs
) -> Dict[str, float]:
    """Every planning variant's cost (message-level path choice, paper §V)."""
    conc = kwargs.pop("concurrency", None)
    if conc is None:
        conc = int(spec.fact("injectors_per_node", 1))
    return {
        name: float(
            path_time(
                spec, decl.path, nbytes_per_msg, n_msgs,
                lanes=int(spec.value(decl.lanes, default=1)),
                concurrency=conc, **kwargs,
            )
        )
        for name, decl in spec.plan_variants.items()
    }


# --------------------------------------------------------------------------
# Register-time spec validation.
#
# Hard sanity only: a typo'd tier parameter (negative alpha, NaN beta, zero
# width) used to surface as a nonsense simulation hours later; rejecting it
# at registration pins the blame on the spec.  The checks are deliberately
# self-contained — repro_torch.analysis.specs layers the softer plausibility
# lints (unit magnitudes, locality ordering) on top, and importing it here
# would cycle (analysis modules import this one).
# --------------------------------------------------------------------------

def validate_spec(spec: MachineSpec) -> None:
    """Reject structurally broken specs (non-finite/negative tier params).

    Raises ``ValueError`` naming the machine, tier and offending value.
    Probes each tier's postal model at :data:`_PROBE_SIZES` so segmented
    models are checked in every protocol segment.
    """
    for key, tier in spec.tiers.items():
        if tier.width < 1:
            raise ValueError(
                f"machine {spec.name!r} tier {key!r}: width {tier.width} < 1"
            )
        if tier.beta_N is not None and not (
            math.isfinite(tier.beta_N) and tier.beta_N >= 0.0
        ):
            raise ValueError(
                f"machine {spec.name!r} tier {key!r}: "
                f"beta_N {tier.beta_N!r} must be finite and >= 0"
            )
        for s in _PROBE_SIZES:
            p = tier.params_for(s)
            for field, v in (("alpha", p.alpha), ("beta", p.beta)):
                if not (math.isfinite(v) and v >= 0.0):
                    raise ValueError(
                        f"machine {spec.name!r} tier {key!r}: {field} {v!r} "
                        f"at {s:.0f} bytes must be finite and >= 0 "
                        f"(seconds resp. seconds/byte)"
                    )


# --------------------------------------------------------------------------
# Elastic reshape: derive the surviving-mesh spec after host loss.
# --------------------------------------------------------------------------

def shrink_spec(
    spec: MachineSpec,
    lost_hosts: Union[int, Iterable[int]],
    *,
    total_ranks: Optional[int] = None,
    name: Optional[str] = None,
) -> MachineSpec:
    """Derive the MachineSpec for the mesh that survives losing hosts.

    ``lost_hosts`` is a count or an iterable of rank indices.  The derived
    spec records the surviving participant count as fact ``n_gpus`` and the
    per-node injector count as fact ``ppn``; when the job fit on a single
    node/pod, the node shape itself (``gpus_per_node`` / ``hosts_per_pod``
    and the matching tier widths) shrinks too.  Because ``facts`` are part
    of :attr:`MachineSpec.fingerprint`, re-registering the shrunk spec
    under the old name bumps the registry generation *and* misses every
    cached plan — the exact PR-7 re-plan contract, now triggered by loss
    instead of link drift (DESIGN.md §11).  ``provenance`` is inherited
    (the tier constants are still the measured/fitted ones); lineage is
    recorded in ``derived_from``, which — like provenance — stays out of
    the fingerprint.

    ``total_ranks`` overrides the pre-loss participant count when the job
    spans more ranks than one node's worth (the common multi-node case);
    it defaults to fact ``n_gpus`` if present, else one node/pod's width.
    """
    if isinstance(lost_hosts, (int, np.integer)):
        k = int(lost_hosts)
    else:
        lost = sorted({int(h) for h in lost_hosts})
        if any(h < 0 for h in lost):
            raise ValueError(f"negative rank in lost_hosts: {lost}")
        k = len(lost)
    if k < 0:
        raise ValueError(f"lost_hosts count {k} must be >= 0")

    facts = dict(spec.facts)
    tiers = dict(spec.tiers)

    def _shrink_widths(old_w: int, new_w: int, tier_base: str) -> None:
        for key, tier in list(tiers.items()):
            if key.partition(":")[0] == tier_base and tier.width == old_w:
                tiers[key] = dataclasses.replace(tier, width=new_w)

    if "gpus_per_node" in facts:  # GPU family (summit/lassen/gh200/fitted)
        per_node = int(facts["gpus_per_node"])
        total = int(total_ranks if total_ranks is not None
                    else facts.get("n_gpus", per_node))
        survivors = total - k
        if survivors < 1:
            raise ValueError(
                f"shrink_spec({spec.name!r}): {k} lost of {total} ranks "
                f"leaves {survivors} < 1 survivor"
            )
        if total <= per_node:
            # single-node job: the node itself lost GPUs, so per-node
            # shape and the gpu_net lane widths shrink with it
            cores_per_gpu = int(facts.get("cores_per_gpu", 1))
            facts["gpus_per_node"] = survivors
            facts["cpu_cores_per_node"] = cores_per_gpu * survivors
            if int(facts.get("injectors_per_node", 0)) == per_node:
                facts["injectors_per_node"] = survivors
            _shrink_widths(per_node, survivors, "gpu_net")
        facts["n_gpus"] = survivors
        facts["ppn"] = int(facts.get("injectors_per_node", 1))
    elif "hosts_per_pod" in facts:  # TPU family: a rank is a host
        per_pod = int(facts["hosts_per_pod"])
        total = int(total_ranks if total_ranks is not None
                    else facts.get("n_gpus", per_pod))
        survivors = total - k
        if survivors < 1:
            raise ValueError(
                f"shrink_spec({spec.name!r}): {k} lost of {total} hosts "
                f"leaves {survivors} < 1 survivor"
            )
        if total <= per_pod:
            chips_per_host = max(int(facts.get("chips_per_pod", per_pod))
                                 // per_pod, 1)
            facts["hosts_per_pod"] = survivors
            facts["chips_per_pod"] = chips_per_host * survivors
            _shrink_widths(per_pod, survivors, "dcn")
        facts["n_gpus"] = survivors
        facts["ppn"] = int(facts.get("injectors_per_node", 1))
    else:
        raise ValueError(
            f"shrink_spec({spec.name!r}): spec has neither gpus_per_node "
            f"nor hosts_per_pod facts; don't know what a host is here"
        )

    shrunk = dataclasses.replace(
        spec,
        name=name if name is not None else spec.name,
        tiers=tiers,
        facts=facts,
        description=(spec.description +
                     f" [shrunk: {k} host(s) lost, {survivors} survive]"),
        derived_from=spec.derived_from or spec.name,
    )
    validate_spec(shrunk)
    return shrunk


# --------------------------------------------------------------------------
# Registry.
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Union[MachineSpec, Callable[..., MachineSpec]]] = {}
_CACHE: Dict[tuple, MachineSpec] = {}
# bumped on every (re-)registration; decision caches that key on machine
# *names* anywhere (the plan cache in comms.autotune) compare this to drop
# entries resolved against a superseded registration
_GENERATION = 0


def registry_generation() -> int:
    """Monotone counter incremented by every :func:`register_machine`."""
    return _GENERATION


def register_machine(
    name: str, spec_or_factory: Union[MachineSpec, Callable[..., MachineSpec]]
) -> None:
    """Register a spec (or a factory taking shape kwargs) under ``name``.

    Spec instances are validated on the spot; factory outputs are validated
    lazily by :func:`get_machine` when first built (the factory may need
    call-time shape kwargs).
    """
    global _GENERATION
    if isinstance(spec_or_factory, MachineSpec):
        validate_spec(spec_or_factory)
    _REGISTRY[name] = spec_or_factory
    _GENERATION += 1
    stale = [k for k in _CACHE if k[0] == name]
    for k in stale:
        del _CACHE[k]


def get_machine(name: str, **factory_kwargs) -> MachineSpec:
    """Look up a registered machine; factories receive ``factory_kwargs``."""
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KeyError(
            f"unknown machine {name!r}; registered: {sorted(_REGISTRY)}"
        )
    if isinstance(entry, MachineSpec):
        return entry
    key = (name, tuple(sorted(factory_kwargs.items())))
    spec = _CACHE.get(key)
    if spec is None:
        spec = entry(**factory_kwargs)
        validate_spec(spec)
        _CACHE[key] = spec
    return spec


def registered_machines() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_spec(machine: Union[str, "MachineSpec", None], default: str = None) -> MachineSpec:
    """Accept a registry name or an already-built spec (fitted machines are
    often passed directly); None falls back to ``default``."""
    if isinstance(machine, MachineSpec):
        return machine
    return get_machine(machine if machine is not None else default)


def machine_for(topo) -> MachineSpec:
    """Spec for a topology object (anything carrying a ``machine`` name)."""
    name = getattr(topo, "machine", None)
    if name is None:
        raise TypeError(f"topology {topo!r} names no machine")
    entry = _REGISTRY.get(name)
    if callable(entry) and not isinstance(entry, MachineSpec):
        return get_machine(name, topo=topo)
    return get_machine(name)


# --------------------------------------------------------------------------
# Built-in specs: the paper's machines (Tables I-III).
# --------------------------------------------------------------------------

def gpu_family_paths() -> Dict[str, Path]:
    """The GPU-machine path/strategy family, shared by Summit/Lassen/GH200
    and by fitted specs: every path is a tier composition, nothing else."""
    return {
        "gpudirect": Path(
            "gpudirect",
            (Traversal("gpu_net", kind="msgs", lanes=1),),
            "CUDA-aware GPUDirect: one postal hop on the GPU NIC tier (Eq. 3).",
        ),
        "three_step": Path(
            "three_step",
            (
                Traversal("copy_d2h", kind="bulk", lanes=1, dedup=True),
                Traversal("cpu_net", kind="msgs"),
                Traversal("copy_h2d", kind="bulk", lanes=1, dedup=True),
            ),
            "copy.d2h -> cpu_net -> copy.h2d (paper 3-step), bytes split "
            "over the active CPU cores.",
        ),
        "extra_msg": Path(
            "extra_msg",
            (
                Traversal("copy_d2h", kind="bulk", lanes=1, dedup=True),
                Traversal("cpu_net", kind="redist", locality=Locality.ON_NODE,
                          ppn="cpu_cores_per_node"),
                Traversal("cpu_net", kind="msgs", split_msgs=True),
                Traversal("cpu_net", kind="redist", locality=Locality.ON_NODE,
                          ppn="cpu_cores_per_node"),
                Traversal("copy_h2d", kind="bulk", lanes=1, dedup=True),
            ),
            "one copy, scatter to all cores (extra messages), send, gather.",
        ),
        "dup_devptr": Path(
            "dup_devptr",
            (
                Traversal("copy_d2h", kind="bulk", dedup=True, serialize=True),
                Traversal("cpu_net", kind="msgs", split_msgs=True),
                Traversal("copy_h2d", kind="bulk", dedup=True, serialize=True),
            ),
            "each core copies its own slice (duplicate device pointers): "
            "copy-engine launch latency serializes, then all cores send.",
        ),
    }


def gpu_family_strategies() -> Dict[str, StrategyDecl]:
    return {
        "cuda_aware": StrategyDecl("gpudirect", lanes=1),
        "three_step": StrategyDecl("three_step", lanes=1),
        "extra_msg": StrategyDecl("extra_msg", lanes="cores_per_gpu"),
        "dup_devptr": StrategyDecl("dup_devptr", lanes="cores_per_gpu"),
    }


def gpu_plan_variants() -> Dict[str, StrategyDecl]:
    return {
        "gpudirect": StrategyDecl("gpudirect", lanes=1),
        "three_step_1core": StrategyDecl("three_step", lanes=1),
        "three_step_allcores": StrategyDecl("three_step", lanes="cores_per_gpu"),
    }


def gpu_machine_spec(machine: str) -> MachineSpec:
    """Build a paper machine (Tables I-III keyed by ``machine``) as a spec."""
    shape = MACHINES[machine]
    cores_per_gpu = shape["cpu_cores_per_node"] // shape["gpus_per_node"]
    tiers: Dict[str, TransportTier] = {}
    for dev, tier_name, width in (
        ("gpu", "gpu_net", shape["gpus_per_node"]),
        ("cpu", "cpu_net", cores_per_gpu),
    ):
        for loc in Locality:
            tiers[f"{tier_name}:{loc.value}"] = TransportTier(
                name=f"{tier_name}:{loc.value}",
                model=paper_model(machine, dev, loc),
                beta_N=TABLE_III_BETA_N[machine][dev],
                width=width,
            )
    for sock in ("on-socket", "off-socket"):
        for direction, tier_name in (
            (CopyDirection.D2H, "copy_d2h"),
            (CopyDirection.H2D, "copy_h2d"),
        ):
            tiers[f"{tier_name}:{sock}"] = TransportTier(
                name=f"{tier_name}:{sock}",
                model=SimplePostalModel(TABLE_II[machine][sock][direction]),
                width=cores_per_gpu,
                serialize_alpha=True,
            )
    return MachineSpec(
        name=machine,
        tiers=tiers,
        paths=gpu_family_paths(),
        strategies=gpu_family_strategies(),
        plan_variants=gpu_plan_variants(),
        facts={
            "gpus_per_node": shape["gpus_per_node"],
            "cpu_cores_per_node": shape["cpu_cores_per_node"],
            "sockets": shape["sockets"],
            "cores_per_gpu": cores_per_gpu,
            "injectors_per_node": shape["gpus_per_node"],
        },
        crossover_paths=("gpudirect", "three_step"),
        description=f"paper machine {machine!r} (Tables I-III, verbatim)",
    )


# --------------------------------------------------------------------------
# Built-in spec: the TPU v5e target (same algebra, ICI/DCN tiers).
# --------------------------------------------------------------------------

def tpu_machine_spec(topo=None) -> MachineSpec:
    """Spec for a TPU pod topology: ICI + DCN tiers, three cross-pod paths."""
    from repro_torch.core.topology import TpuPodTopology

    if topo is None:
        topo = TpuPodTopology(pods=1)
    sys = topo.system
    hops_diameter = topo.torus_x // 2
    tiers = {
        "ici": TransportTier(
            name="ici",
            model=SimplePostalModel(PostalParams(sys.ici_alpha, sys.ici_beta)),
            width=sys.ici_links_per_chip,
        ),
        "dcn": TransportTier(
            name="dcn",
            model=SimplePostalModel(
                PostalParams(sys.dcn_alpha, sys.dcn_beta_per_host)
            ),
            beta_N=sys.dcn_beta_N_pod,
            width=topo.hosts_per_pod,
        ),
    }
    ici_gather = Traversal(
        "ici", kind="bulk", byte_scale="chips_per_pod", lanes="ici_links",
        alpha_extra=sys.ici_hop_alpha * max(hops_diameter - 1, 0), ppn=1,
    )
    ici_rebucket = Traversal(
        "ici", kind="bulk", byte_scale=1.0, lanes="ici_links",
        alpha_extra=sys.ici_hop_alpha, ppn=1,
    )
    paths = {
        "direct": Path(
            "direct",
            (Traversal("dcn", kind="msgs", lanes=1, ppn="hosts_per_pod"),),
            "every chip sends its slice cross-pod; all hosts inject.",
        ),
        "staged": Path(
            "staged",
            (
                ici_gather,
                Traversal("dcn", kind="bulk", byte_scale="chips_per_pod",
                          lanes=1, ppn=1),
                ici_gather,
            ),
            "ici_gather -> dcn (one stream) -> ici_scatter (3-step analogue).",
        ),
        "multirail": Path(
            "multirail",
            (
                ici_rebucket,
                Traversal("dcn", kind="bulk", byte_scale="chips_per_pod",
                          lanes="hosts_per_pod", ppn="hosts_per_pod"),
                ici_rebucket,
            ),
            "re-bucket so every host NIC injects an equal share "
            "(Dup-Devptr analogue).",
        ),
    }
    strategies = {
        "direct": StrategyDecl("direct", lanes=1),
        "staged": StrategyDecl("staged", lanes=1),
        "multirail": StrategyDecl("multirail", lanes=1),
    }
    return MachineSpec(
        name=getattr(topo, "machine", "tpu_v5e"),
        tiers=tiers,
        paths=paths,
        strategies=strategies,
        plan_variants=strategies,
        facts={
            "chips_per_pod": topo.chips_per_pod,
            "hosts_per_pod": topo.hosts_per_pod,
            "ici_links": sys.ici_links_per_chip,
            "torus_x": topo.torus_x,
            "ici_hop_alpha": sys.ici_hop_alpha,
            "injectors_per_node": 1,
        },
        crossover_paths=("direct", "staged"),
        description="TPU v5e pod: ICI torus + per-host DCN NICs",
    )


# --------------------------------------------------------------------------
# Built-in spec: a tightly-coupled GH200-like superchip node.
#
# Representative (not measured) figures for a Grace-Hopper NVL node:
# NVLink-C2C makes host<->device copies ~20x cheaper than PCIe staging
# (450 GB/s coherent, ~2us launch), each superchip owns a 400 Gb/s NIC
# (~50 GB/s) for GPUDirect RDMA, and the CPU path shares the same NIC.
# The point of this entry is extensibility: the Khalilov et al. (2408.11556)
# transport zoo drops into the same tier algebra with zero solver changes.
# --------------------------------------------------------------------------

def gh200_like_spec() -> MachineSpec:
    gpus_per_node = 4
    cores_per_gpu = 72  # Grace: 72 Neoverse cores per superchip
    # single-segment models are enough for a representative entry
    gpu_net = SimplePostalModel(PostalParams(3.5e-06, 2.0e-11))   # ~50 GB/s NIC
    cpu_net = SimplePostalModel(PostalParams(2.2e-06, 2.1e-11))   # same NIC, CPU-driven
    c2c = SimplePostalModel(PostalParams(2.0e-06, 2.2e-12))       # NVLink-C2C 450 GB/s
    tiers: Dict[str, TransportTier] = {}
    for loc in Locality:
        tiers[f"gpu_net:{loc.value}"] = TransportTier(
            f"gpu_net:{loc.value}", gpu_net, beta_N=5.0e-12,
            width=gpus_per_node,
        )
        tiers[f"cpu_net:{loc.value}"] = TransportTier(
            f"cpu_net:{loc.value}", cpu_net, beta_N=5.0e-12,
            width=cores_per_gpu,
        )
    for sock in ("on-socket", "off-socket"):
        tiers[f"copy_d2h:{sock}"] = TransportTier(
            f"copy_d2h:{sock}", c2c, width=cores_per_gpu, serialize_alpha=True
        )
        tiers[f"copy_h2d:{sock}"] = TransportTier(
            f"copy_h2d:{sock}", c2c, width=cores_per_gpu, serialize_alpha=True
        )
    return MachineSpec(
        name="gh200",
        tiers=tiers,
        paths=gpu_family_paths(),
        strategies=gpu_family_strategies(),
        plan_variants=gpu_plan_variants(),
        facts={
            "gpus_per_node": gpus_per_node,
            "cpu_cores_per_node": gpus_per_node * cores_per_gpu,
            "sockets": gpus_per_node,
            "cores_per_gpu": cores_per_gpu,
            "injectors_per_node": gpus_per_node,
        },
        crossover_paths=("gpudirect", "three_step"),
        description="GH200-like tightly-coupled node (representative figures; "
                    "NVLink-C2C host<->device, per-superchip NDR NIC)",
        provenance="representative",
    )


def _register_builtins() -> None:
    for name in TABLE_I:
        register_machine(name, gpu_machine_spec(name))
    register_machine("tpu_v5e", tpu_machine_spec)
    register_machine("gh200", gh200_like_spec())


_register_builtins()

"""Deterministic fault-scenario DSL: a timeline of failures to inject.

A :class:`Scenario` is an ordered timeline of :class:`ScenarioEvent`s —
``host_drop``, ``link_sag``, ``straggler``, ``flap``, ``recover`` — pinned
to step indices.  One scenario drives every layer of the stack the same
way (DESIGN.md §11):

* the **DES simulator**: :func:`capacity_overrides` maps the active
  events onto the canonical ``{tier}.rank{r}`` resource pools
  (:mod:`repro_torch.core.schedule`), so a sagged or dead rank's pool loses
  capacity and the engine prices the contention.  *Removing* a host from
  the problem proper is a re-plan, not an override —
  :func:`repro_torch.core.machine.shrink_spec` derives the surviving-mesh spec
  and re-registration invalidates every cached plan;
* the **live loops**: :class:`ScenarioInjector` adapts the timeline to a
  recovery loop (``fault_hook`` raising
  :class:`~repro_torch.runtime.fault.HostLost` at drop steps; the serve loop
  reads the drops itself), to step timing
  (``step_time_scale`` for stragglers), and to the link-health observatory
  (``feed_drift`` streams sagged measurements into :mod:`repro_torch.obs.drift`
  so the state machine detects the sag exactly as it would live).

Scenarios are plain data: ``to_json``/``from_json`` round-trip, and
:func:`generate` builds a random-but-seeded timeline — two calls with the
same seed produce identical scenarios, which is what lets CI chaos drills
gate hard on their outcomes.  A copy of ``repro.runtime.scenarios``.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

HOST_DROP = "host_drop"
LINK_SAG = "link_sag"
STRAGGLER = "straggler"
FLAP = "flap"
RECOVER = "recover"

EVENT_KINDS = (HOST_DROP, LINK_SAG, STRAGGLER, FLAP, RECOVER)


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One timeline entry.

    ``at`` is the step index the event fires on.  ``host`` names a
    participant rank (drops, stragglers, per-rank sags); ``tier`` a
    transport-tier family (``"gpu_net"``, ``"dcn"``).  ``factor`` is the
    slowdown a sag/straggler applies (measured = factor x predicted).
    ``duration`` bounds an effect in steps; 0 means "until a matching
    ``recover``".  For ``flap`` the effect toggles on/off every
    ``duration`` steps (a link that oscillates, the hardest case for a
    detector — it must not latch ``degraded`` forever nor thrash).
    """

    at: int
    kind: str
    host: Optional[int] = None
    tier: Optional[str] = None
    factor: float = 1.0
    duration: int = 0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {self.kind!r}; one of {EVENT_KINDS}"
            )
        if self.at < 0:
            raise ValueError(f"event at={self.at} must be >= 0")
        if self.kind == HOST_DROP and self.host is None:
            raise ValueError("host_drop needs host=")
        if self.kind in (LINK_SAG, FLAP) and self.tier is None:
            raise ValueError(f"{self.kind} needs tier=")
        if self.kind == STRAGGLER and self.host is None:
            raise ValueError("straggler needs host=")
        if self.kind in (LINK_SAG, STRAGGLER, FLAP) and self.factor <= 1.0:
            raise ValueError(
                f"{self.kind} factor {self.factor} must be > 1 (a slowdown)"
            )
        if self.kind == FLAP and self.duration < 1:
            raise ValueError("flap needs duration >= 1 (the toggle period)")

    def to_json(self) -> dict:
        d = {"at": self.at, "kind": self.kind}
        for k in ("host", "tier"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        if self.factor != 1.0:
            d["factor"] = self.factor
        if self.duration:
            d["duration"] = self.duration
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ScenarioEvent":
        return cls(**{k: d[k] for k in
                      ("at", "kind", "host", "tier", "factor", "duration")
                      if k in d})

    def _matches_recover(self, ev: "ScenarioEvent") -> bool:
        """Does recover-event ``ev`` end this effect?  A recover with no
        host/tier qualifier ends everything; qualified recovers must match."""
        if ev.host is not None and ev.host != self.host:
            return False
        if ev.tier is not None and ev.tier != self.tier:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class ScenarioState:
    """Effects active at one step (the replayed view of the timeline)."""

    lost_hosts: Tuple[int, ...]
    sags: Tuple[Tuple[str, Optional[int], float], ...]  # (tier, host, factor)
    straggler_factor: float  # max active straggler slowdown (1.0 = none)


class Scenario:
    """An immutable, validated, step-indexed failure timeline."""

    def __init__(
        self,
        events: Iterable[ScenarioEvent],
        *,
        seed: int = 0,
        name: str = "scenario",
    ):
        self.events: Tuple[ScenarioEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.at, EVENT_KINDS.index(e.kind)))
        )
        self.seed = int(seed)
        self.name = name

    def __repr__(self) -> str:
        return (f"Scenario({self.name!r}, seed={self.seed}, "
                f"{len(self.events)} events)")

    def events_at(self, step: int) -> List[ScenarioEvent]:
        return [e for e in self.events if e.at == step]

    # -- replay ------------------------------------------------------------

    def state_at(self, step: int) -> ScenarioState:
        """Replay the timeline up to (and including) ``step``.

        O(len(events)) per call — scenarios are short; determinism and
        obviousness beat cleverness here.
        """
        lost: Set[int] = set()
        active: List[ScenarioEvent] = []  # open-ended sags/stragglers/flaps
        for ev in self.events:
            if ev.at > step:
                break
            if ev.kind == HOST_DROP:
                lost.add(ev.host)
            elif ev.kind == RECOVER:
                if ev.host is not None and ev.tier is None:
                    lost.discard(ev.host)
                active = [a for a in active if not a._matches_recover(ev)]
            else:
                active.append(ev)
        sags: List[Tuple[str, Optional[int], float]] = []
        straggle = 1.0
        for ev in active:
            if ev.duration and ev.kind != FLAP:
                if step >= ev.at + ev.duration:
                    continue
            if ev.kind == FLAP:
                # on for [at, at+d), off for [at+d, at+2d), on again, ...
                if ((step - ev.at) // ev.duration) % 2 == 1:
                    continue
            if ev.kind in (LINK_SAG, FLAP):
                sags.append((ev.tier, ev.host, ev.factor))
            elif ev.kind == STRAGGLER:
                straggle = max(straggle, ev.factor)
        return ScenarioState(
            lost_hosts=tuple(sorted(lost)),
            sags=tuple(sags),
            straggler_factor=straggle,
        )

    def lost_hosts(self, step: int) -> Tuple[int, ...]:
        return self.state_at(step).lost_hosts

    def final_lost_hosts(self) -> Tuple[int, ...]:
        last = max((e.at for e in self.events), default=0)
        return self.lost_hosts(last)

    # -- DES injection -----------------------------------------------------

    def capacity_overrides(self, spec, step: int) -> Dict[str, int]:
        """Active events -> engine ``capacity_overrides`` on the canonical
        ``{tier}.rank{r}`` pools (DESIGN.md §6.1 naming).

        * a sag/flap of factor f on tier T (optionally rank r) squeezes the
          matching ``T*.rank{r}`` pools to ``max(1, width // f)`` slots —
          the engine then prices the queueing the lost lanes cause;
        * a lost host's pools collapse to one slot on EVERY tier: traffic a
          stale plan still routes at the dead rank serializes hard.  This
          is deliberately the *pessimistic stale-plan view*; the correct
          response is :func:`repro_torch.core.machine.shrink_spec` + re-plan,
          which removes the rank from the problem instead.
        """
        state = self.state_at(step)
        out: Dict[str, int] = {}

        def squeeze(tier_base: Optional[str], host: Optional[int], cap_of):
            for key, tier in spec.tiers.items():
                base = key.partition(":")[0]
                if tier_base is not None and base != tier_base:
                    continue
                ranks = (host,) if host is not None else range(tier.width)
                for r in ranks:
                    rname = f"{key}.rank{r}"
                    cap = cap_of(tier)
                    out[rname] = min(out.get(rname, cap), cap)

        for tier_base, host, factor in state.sags:
            squeeze(tier_base, host,
                    lambda t, f=factor: max(1, int(t.width // f)))
        for host in state.lost_hosts:
            squeeze(None, host, lambda t: 1)
        return out

    # -- serialization -----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "events": [e.to_json() for e in self.events],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Scenario":
        return cls(
            [ScenarioEvent.from_json(e) for e in d.get("events", ())],
            seed=int(d.get("seed", 0)),
            name=d.get("name", "scenario"),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_json(json.load(f))


def single_host_drop(at: int, host: int, *, name: str = "host_drop") -> Scenario:
    """The serve ``--fail-at``/``--fail-host`` timeline: one dropped host."""
    return Scenario([ScenarioEvent(at=at, kind=HOST_DROP, host=host)],
                    name=name)


def generate(
    seed: int,
    total_steps: int,
    *,
    hosts: int = 8,
    tiers: Sequence[str] = ("gpu_net",),
    n_events: int = 4,
    max_drops: int = 1,
    sag_factor: Tuple[float, float] = (2.0, 16.0),
    name: Optional[str] = None,
) -> Scenario:
    """Seeded random scenario: same seed -> identical timeline, always.

    Drops are capped at ``max_drops`` (and never below one surviving
    host); sags/stragglers/flaps draw factors from ``sag_factor`` and get
    bounded durations so a generated scenario always ends calm enough for
    a run to finish.
    """
    rng = random.Random(int(seed))
    events: List[ScenarioEvent] = []
    drops = 0
    alive = list(range(hosts))
    for _ in range(n_events):
        at = rng.randrange(1, max(total_steps, 2))
        kind = rng.choice((HOST_DROP, LINK_SAG, STRAGGLER, FLAP))
        if kind == HOST_DROP and (drops >= max_drops or len(alive) <= 1):
            kind = LINK_SAG
        factor = round(rng.uniform(*sag_factor), 3)
        if kind == HOST_DROP:
            host = rng.choice(alive)
            alive.remove(host)
            drops += 1
            events.append(ScenarioEvent(at=at, kind=HOST_DROP, host=host))
        elif kind == LINK_SAG:
            events.append(ScenarioEvent(
                at=at, kind=LINK_SAG, tier=rng.choice(tuple(tiers)),
                factor=factor,
                duration=rng.randrange(1, max(total_steps // 2, 2)),
            ))
        elif kind == STRAGGLER:
            events.append(ScenarioEvent(
                at=at, kind=STRAGGLER, host=rng.choice(alive), factor=factor,
                duration=rng.randrange(1, max(total_steps // 2, 2)),
            ))
        else:
            events.append(ScenarioEvent(
                at=at, kind=FLAP, tier=rng.choice(tuple(tiers)),
                host=rng.choice(alive), factor=factor,
                duration=rng.randrange(1, 4),
            ))
    return Scenario(events, seed=seed, name=name or f"generated-{seed}")


class ScenarioInjector:
    """Adapts a scenario to the live runtime loops.

    * ``fault_hook`` plugs into a recovery loop
      (:func:`repro_torch.runtime.fault.run_with_recovery`) — it raises
      :class:`~repro_torch.runtime.fault.HostLost` the first time each
      ``host_drop`` step is reached.  Replays after a restart revisit the
      step without re-raising (the host is already gone), matching how a
      real restart sees the shrunk world.
    * ``step_time_scale`` returns the active straggler slowdown for a step
      (multiply the measured/simulated step duration by it).
    * ``feed_drift`` streams one drift record per active sag into
      :mod:`repro_torch.obs.drift` (measured = factor x predicted), which is all
      the link-health observatory needs to detect the degradation.
    """

    def __init__(
        self,
        scenario: Scenario,
        *,
        machine: Optional[str] = None,
        spec=None,
        probe_bytes: float = float(1 << 20),
    ):
        self.scenario = scenario
        self.machine = machine
        self.spec = spec
        self.probe_bytes = float(probe_bytes)
        self._fired: Set[int] = set()  # event indices already raised

    def fault_hook(self, step: int) -> None:
        from repro_torch.runtime.fault import HostLost

        for i, ev in enumerate(self.scenario.events):
            if ev.at == step and ev.kind == HOST_DROP and i not in self._fired:
                self._fired.add(i)
                raise HostLost(ev.host, f"scenario host {ev.host} lost at "
                                        f"step {step}")

    def step_time_scale(self, step: int) -> float:
        return self.scenario.state_at(step).straggler_factor

    def feed_drift(self, step: int) -> int:
        """Record the active sags as drift records; returns how many."""
        if self.spec is None or self.machine is None:
            return 0
        from repro_torch.obs import drift as obs_drift

        n = 0
        for tier_base, _host, factor in self.scenario.state_at(step).sags:
            for key, tier in self.spec.tiers.items():
                if key.partition(":")[0] != tier_base:
                    continue
                t_model = float(tier.time(self.probe_bytes))
                obs_drift.record(self.machine, key, "scenario",
                                 self.probe_bytes, t_model, factor * t_model)
                n += 1
        return n


def main(argv=None) -> int:
    """CLI: generate / inspect a seeded scenario (the CI determinism probe).

    ``python -m repro_torch.runtime.scenarios --seed 7 --steps 12 --json`` emits
    the timeline; the same invocation always emits the same bytes.
    """
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="python -m repro_torch.runtime.scenarios")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--events", type=int, default=4)
    ap.add_argument("--tiers", default="gpu_net",
                    help="comma-separated tier families sags may hit")
    ap.add_argument("--load", metavar="PATH", default=None,
                    help="load a scenario JSON instead of generating")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", metavar="PATH", default=None)
    args = ap.parse_args(argv)

    if args.load:
        sc = Scenario.load(args.load)
    else:
        sc = generate(args.seed, args.steps, hosts=args.hosts,
                      n_events=args.events,
                      tiers=tuple(t for t in args.tiers.split(",") if t))
    if args.out:
        sc.save(args.out)
    if args.json:
        json.dump(sc.to_json(), sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(sc)
        for ev in sc.events:
            print(f"  step {ev.at:>4}  {ev.kind:<10}"
                  + (f" host={ev.host}" if ev.host is not None else "")
                  + (f" tier={ev.tier}" if ev.tier is not None else "")
                  + (f" x{ev.factor}" if ev.factor != 1.0 else "")
                  + (f" for {ev.duration} steps" if ev.duration else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's model-guided strategy selection (``repro_torch.comms.autotune``)
against the JAX package's (``repro.comms.autotune``) on the CPU.

Every selector over the registry's built-in machines, a few mesh shapes and
an octave sweep of payload sizes must give the same picks, and the plan
cache must see the same hits and misses in the same order (its log2
buckets, its fingerprint keys and its registry-generation invalidation);
``explain_bottleneck`` must give the same report.
"""
import time

import pytest

from _torch_obs_parity import (  # noqa: F401  (the fixture is autouse)
    _fresh_planners,
    r_autotune,
    r_core,
    r_obs,
    same,
    shared_metrics,
    t_autotune,
    t_core,
    t_obs,
)

MACHINES = ("gh200", "lassen", "summit", "tpu_v5e")
MESHES = ({"data": 1, "model": 1}, {"data": 8, "model": 4}, {"pod": 2, "data": 16, "model": 16},
          {"pod": 4, "data": 8, "model": 8})
# an octave sweep of payloads (1 B - 64 MiB), then the same sizes nudged
# within their log2 bucket (cache hits) and across it
SIZES = [float(2 ** k) for k in range(0, 27, 2)]
NUDGED = [s * 1.04 for s in SIZES] + [s * 1.6 for s in SIZES[::3]]


def _both(call):
    """``call(core, autotune)`` in each package with its metrics on:
    (result, plan-cache info) in each."""
    out = []
    for core, autotune, obs in ((r_core, r_autotune, r_obs), (t_core, t_autotune, t_obs)):
        obs.metrics.enable()
        out.append((call(core, autotune), autotune.plan_cache_info()))
    return out


def _sweep(select):
    """Picks and the cache's (hits, misses, entries) after every call."""
    def run(core, autotune):
        seq = []
        for nbytes in SIZES + NUDGED:
            pick = select(autotune, nbytes)
            info = autotune.plan_cache_info()
            seq.append((pick, info["hits"], info["misses"], info["entries"]))
        return seq
    (r, _), (t, _) = _both(run)
    assert t == r
    assert r[-1][1] > 0 or all(p[2] == 0 for p in r)  # the nudged sizes hit
    return r


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("n_msgs", [1, 8])
def test_select_transfer_path_and_collective_match_reference(machine, n_msgs):
    from repro.core.params import Locality as RLoc
    from repro_torch.core.params import Locality as TLoc

    locs = {"r": RLoc, "t": TLoc}
    for loc in RLoc:
        _sweep(lambda a, s, loc=loc: a.select_transfer_path(
            machine, s, n_msgs, locality=locs["r" if a is r_autotune else "t"][loc.name]))
    for split in (False, True):
        _sweep(lambda a, s, split=split: a.select_collective_strategy(machine, s, n_msgs, split))


@pytest.mark.parametrize("machine", MACHINES)
def test_select_schedule_matches_reference(machine):
    for peers in (None, 4):
        _sweep(lambda a, s, peers=peers: a.select_schedule(machine, s, 4, peers=peers))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m.values())))
def test_mesh_selectors_match_reference(mesh):
    picks = _sweep(lambda a, s: a.select_allreduce_strategy(mesh, s))
    if mesh.get("pod", 1) == 1:
        assert {p[0] for p in picks} == {"flat"} and picks[-1][2] == 0  # no cache probe
    _sweep(lambda a, s: a.select_alltoall_strategy(mesh, s, 4, crosses_pod=True))
    _sweep(lambda a, s: a.select_alltoall_strategy(mesh, s, 1, crosses_pod=False))
    axes = [k for k in mesh if k != "model"][:2]
    _sweep(lambda a, s: a.select_moe_dispatch_strategy(mesh, axes, s))
    _sweep(lambda a, s: a.select_allreduce_strategy(mesh, s, machine="summit"))


def test_registry_generation_invalidates_like_reference():
    """Re-registering any machine drops the cache at the next call;
    ``set_active_machine`` drops it and moves the default."""
    def run(core, autotune):
        seq = []
        mesh = {"pod": 2, "data": 16, "model": 16}
        for step in range(3):
            for s in SIZES[4:8]:
                seq.append(autotune.select_allreduce_strategy(mesh, s))
                seq.append(autotune.select_schedule(None, s, 4))
            seq.append(dict(autotune.plan_cache_info()))
            core.register_machine("scratch_probe", core.get_machine("summit"))
        old = autotune.set_active_machine("summit")
        seq.append((old, autotune.active_machine(), dict(autotune.plan_cache_info())))
        seq.append(autotune.select_schedule(None, 4096.0, 4))
        seq.append(autotune.select_allreduce_strategy(mesh, 4096.0))  # falls back to tpu_v5e
        autotune.set_active_machine(old)
        return seq
    (r, ri), (t, ti) = _both(run)
    assert t == r and ti == ri
    assert shared_metrics(t_obs.metrics) == shared_metrics(r_obs.metrics)


@pytest.mark.parametrize("machine", MACHINES + (None,))
@pytest.mark.parametrize("nbytes,n_msgs", [(64.0, 1), (65536.0, 8), (float(1 << 22), 2)])
def test_explain_bottleneck_matches_reference(machine, nbytes, n_msgs):
    """The default pick's report, every declared strategy's and every
    library schedule's, through the engine sink into ``engine.*``."""
    def run(core, autotune):
        spec = core.get_machine(machine or "tpu_v5e")
        names = [None] + sorted(spec.strategies) + sorted(
            core.schedule.candidate_schedules(spec, nbytes, n_msgs))
        return [autotune.explain_bottleneck(machine, nbytes, n_msgs, strategy=s) for s in names]
    (r, ri), (t, ti) = _both(run)
    same(r, t)
    assert ti == ri
    assert shared_metrics(t_obs.metrics) == shared_metrics(r_obs.metrics)
    with pytest.raises(KeyError, match="unknown schedule"):
        t_autotune.explain_bottleneck(machine, nbytes, n_msgs, strategy="no_such")


def test_measured_autotune_matches_reference():
    """A clear winner: the same pick, agreement, drift records and
    ``autotune.*`` counters."""
    def run(core, autotune):
        cands = {"fast": lambda: None, "slow": lambda: time.sleep(2e-3)}
        rec = autotune.measured_autotune(cands, model_pick="slow", reps=2, warmup=1,
                                         predicted={"fast": 1e-6, "slow": 2e-3},
                                         machine="summit", nbytes=4096.0)
        drift = [(d.machine, d.tier, d.collective, d.nbytes, d.predicted)
                 for d in (r_obs if autotune is r_autotune else t_obs).drift.records()]
        return rec.strategy, rec.model_pick, rec.agreed, sorted(rec.measured), drift
    (r, _), (t, _) = _both(run)
    assert t == r and r[:3] == ("fast", "slow", False)
    snap = lambda m: {k: v for k, v in m.to_json()["counters"].items()  # noqa: E731
                      if k.startswith("autotune.")}
    assert snap(t_obs.metrics) == snap(r_obs.metrics) == {"autotune.runs": 1.0,
                                                          "autotune.disagreed": 1.0}


def test_comms_package_exports_autotune_only():
    """The package exports autotune's selectors, and with the collectives
    ported every public name of the reference's ``repro.comms``."""
    import repro.comms as rc
    import repro_torch.comms as tc

    public = {k for k in dir(tc) if not k.startswith("_")}
    assert {"select_allreduce_strategy", "select_alltoall_strategy", "select_schedule",
            "explain_bottleneck", "clear_plan_cache"} <= public
    assert {k for k in dir(rc) if not k.startswith("_")} <= public
    assert callable(tc.allreduce) and callable(tc.alltoall)
    assert t_autotune._DEFAULT_MACHINE == r_autotune._DEFAULT_MACHINE == "tpu_v5e"
    assert t_autotune._BUCKETS_PER_OCTAVE == r_autotune._BUCKETS_PER_OCTAVE
    for s in SIZES + NUDGED + [0.0, 0.5, 1.0, 3.0]:
        assert t_autotune._bucket(s) == r_autotune._bucket(s)

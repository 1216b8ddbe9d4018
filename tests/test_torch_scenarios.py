"""The port's failure scenarios, fault types and elastic re-plan
(``repro_torch.runtime.{scenarios,fault,elastic}``) against the JAX
package's (``repro.runtime``) on the CPU.

A scenario is plain data and its replay is host code, so the same seed must
give the same JSON, the same state at every step, the same capacity
overrides and the same drift records; a host drop must shrink the machine
to the reference's fingerprint.
"""
import json

import pytest

import repro.runtime.elastic as r_elastic
import repro.runtime.fault as r_fault
import repro.runtime.scenarios as r_sc
import repro_torch.runtime.elastic as t_elastic
import repro_torch.runtime.fault as t_fault
import repro_torch.runtime.scenarios as t_sc
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

GENERATED = [dict(seed=3, total_steps=12, hosts=4, n_events=4, tiers=("dcn",)),
             dict(seed=7, total_steps=16),
             dict(seed=11, total_steps=40, hosts=8, n_events=9, tiers=("gpu_net", "dcn"),
                  max_drops=2),
             dict(seed=0, total_steps=2, hosts=1, n_events=3)]


def _generate(sc, kw):
    kw = dict(kw)
    return sc.generate(kw.pop("seed"), kw.pop("total_steps"), **kw)


@pytest.mark.parametrize("kw", GENERATED, ids=lambda k: f"seed{k['seed']}")
def test_generate_and_replay_match_reference(kw):
    """The same JSON, the same state and lost hosts at every step, and the
    same capacity overrides on the machines the drills use."""
    r, t = _generate(r_sc, kw), _generate(t_sc, kw)
    assert json.dumps(t.to_json(), sort_keys=True) == json.dumps(r.to_json(), sort_keys=True)
    assert repr(t) == repr(r)
    last = max((e.at for e in r.events), default=0) + 4
    for step in range(last):
        same(r.state_at(step), t.state_at(step), where=f"step {step}")
        assert t.lost_hosts(step) == r.lost_hosts(step)
        assert [e.to_json() for e in t.events_at(step)] == [e.to_json() for e in r.events_at(step)]
        for machine in ("tpu_v5e", "summit"):
            assert t.capacity_overrides(t_core.get_machine(machine), step) == \
                r.capacity_overrides(r_core.get_machine(machine), step)
    assert t.final_lost_hosts() == r.final_lost_hosts()
    again = t_sc.Scenario.from_json(json.loads(json.dumps(t.to_json())))
    assert again.to_json() == t.to_json()


def test_scenario_save_load_and_events(tmp_path):
    ev = [t_sc.ScenarioEvent(at=4, kind="flap", tier="dcn", host=1, factor=3.0, duration=2),
          t_sc.ScenarioEvent(at=2, kind="host_drop", host=3),
          t_sc.ScenarioEvent(at=6, kind="recover", host=1),
          t_sc.ScenarioEvent(at=1, kind="straggler", host=0, factor=2.5, duration=3)]
    sc = t_sc.Scenario(ev, seed=5, name="hand")
    path = tmp_path / "sc.json"
    sc.save(str(path))
    ref = r_sc.Scenario.load(str(path))
    assert ref.to_json() == t_sc.Scenario.load(str(path)).to_json() == sc.to_json()
    for step in range(10):
        same(ref.state_at(step), sc.state_at(step))
    one = t_sc.single_host_drop(5, 2)
    assert one.to_json() == r_sc.single_host_drop(5, 2).to_json()
    bad = [dict(at=0, kind="melt"), dict(at=-1, kind="host_drop", host=0),
           dict(at=0, kind="host_drop"), dict(at=0, kind="link_sag", factor=2.0),
           dict(at=0, kind="straggler", factor=2.0), dict(at=0, kind="link_sag", tier="dcn"),
           dict(at=0, kind="flap", tier="dcn", factor=2.0)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            r_sc.ScenarioEvent(**kw)
        with pytest.raises(ValueError) as got:
            t_sc.ScenarioEvent(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", GENERATED[:3], ids=lambda k: f"seed{k['seed']}")
def test_injector_matches_reference(kw):
    """``feed_drift`` writes the same drift records (and so the same link
    health), ``step_time_scale`` the same factors; ``fault_hook`` raises the
    port's ``HostLost`` once for each drop."""
    out = []
    for sc_mod, core, obs in ((r_sc, r_core, r_obs), (t_sc, t_core, t_obs)):
        sc = _generate(sc_mod, kw)
        inj = sc_mod.ScenarioInjector(sc, machine="tpu_v5e", spec=core.get_machine("tpu_v5e"))
        fed, scales = [], []
        for step in range(kw["total_steps"] + 2):
            fed.append(inj.feed_drift(step))
            scales.append(inj.step_time_scale(step))
        assert sc_mod.ScenarioInjector(sc).feed_drift(0) == 0  # no machine: nothing
        out.append((fed, scales, obs.drift.records(), obs.health.monitor().snapshot()))
    same(out[0], out[1])
    sc = _generate(t_sc, kw)
    inj = t_sc.ScenarioInjector(sc)
    drops = [e for e in sc.events if e.kind == "host_drop"]
    for ev in drops:
        with pytest.raises(t_fault.HostLost) as lost:
            inj.fault_hook(ev.at)
        assert lost.value.host == ev.host and isinstance(lost.value, t_fault.InjectedFault)
        assert not isinstance(lost.value, r_fault.HostLost)
        inj.fault_hook(ev.at)  # a replay of the step does not raise again
    assert drops or kw["seed"] != 3


def test_scenarios_cli_matches_reference(tmp_path, capsys):
    argv = ["--seed", "3", "--steps", "12", "--hosts", "4", "--events", "4", "--tiers", "dcn"]
    outs = []
    for mod in (r_sc, t_sc):
        path = tmp_path / f"{mod.__name__}.json"
        assert mod.main(argv + ["--json", "--out", str(path)]) == 0
        printed = capsys.readouterr().out
        assert mod.main(["--load", str(path)]) == 0
        outs.append((printed, path.read_text(), capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert "host_drop  host=3" in outs[1][2]


@pytest.mark.parametrize("lost,total", [([0], None), ([3], None), ([1, 2], None), (5, 16)])
def test_shrink_and_replan_matches_reference(lost, total):
    """The shrunk spec re-registered under ``tpu_v5e``: the registry
    generation moves, the fingerprint is the reference's, the next plan is
    made on it, and the same counters and replan records are left."""
    out = []
    for elastic, core, autotune, obs in ((r_elastic, r_core, r_autotune, r_obs),
                                         (t_elastic, t_core, t_autotune, t_obs)):
        obs.metrics.enable()
        before = core.get_machine("tpu_v5e").fingerprint
        gen = core.machine.registry_generation()
        shrunk = elastic.shrink_and_replan("tpu_v5e", lost, total_ranks=total)
        assert core.machine.registry_generation() > gen
        assert core.get_machine("tpu_v5e").fingerprint == shrunk.fingerprint != before
        pick = autotune.select_schedule("tpu_v5e", 65536.0, 4)
        out.append((shrunk.fingerprint, shrunk.facts, pick, obs.health.monitor().replans,
                    shared_metrics(obs.metrics)))
    same(out[0], out[1])
    assert out[1][4]["runtime.elastic.reshapes"] == 1 and out[1][4]["health.replan.host_drop"] == 1


def test_shrunk_tpu_fingerprint():
    """The serve drill's printed fingerprint of ``tpu_v5e`` less host 0."""
    assert t_core.get_machine("tpu_v5e").fingerprint[:12] == "e2e87a7d6371"
    assert t_elastic.shrink_and_replan("tpu_v5e", [0]).fingerprint[:12] == "3a9910f678af"


def test_runtime_package_names():
    import repro.runtime as rr
    import repro_torch.runtime as tr

    import types

    def public(pkg):  # submodules show up once imported, so they are left out
        return {k for k in pkg.__all__ if not isinstance(getattr(pkg, k), types.ModuleType)}

    port = public(tr)
    # the reference's public runtime names, every one of them ported
    assert port == public(rr)
    assert {"EwmaZScore", "StragglerEvent", "StragglerMonitor", "HostLost", "InjectedFault",
            "shrink_and_replan", "Scenario", "ScenarioEvent", "ScenarioInjector",
            "single_host_drop", "run_with_recovery", "BackoffPolicy", "RecoveryExhausted",
            "LoopState", "host_drop_drill", "reshard_tree", "restore_on_mesh"} <= port
    assert str(t_fault.HostLost(4)) == str(r_fault.HostLost(4)) == "host 4 lost"

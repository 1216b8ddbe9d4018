"""The port's observability (``repro_torch.obs``: health, congestion, the whole
of trace and metrics, the engine sink and ``observed``) against the JAX
package's (``repro.obs``) on the CPU.

Both are the same host code in the same order, so the same drift stream must
give the same link states, transitions, snapshot JSON and drill evidence,
the same fits to the float (``same`` at rel 0), and the same trace events for
the same schedule.
"""
import json

import numpy as np
import pytest

import repro.obs.congestion as r_congestion
import repro.obs.health as r_health
import repro.obs.metrics as r_metrics
import repro.obs.trace as r_trace
import repro_torch.obs.congestion as t_congestion
import repro_torch.obs.health as t_health
import repro_torch.obs.metrics as t_metrics
import repro_torch.obs.trace as t_trace
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

BOTH = ((r_core, r_obs, r_health), (t_core, t_obs, t_health))


def _ratio_stream(seed: int) -> list:
    """measured/predicted ratios: a calm warm-up, noise, a single hiccup, a
    sag that degrades the link, a recovery, a second sag and a flap."""
    rng = np.random.default_rng(seed)
    calm = lambda n: (1.0 + 0.02 * rng.standard_normal(n)).tolist()  # noqa: E731
    return (calm(6) + [1.9] + calm(4) + [8.0] * 5 + calm(8) + [3.0] * 3
            + calm(3) + [6.0, 1.0, 6.0, 6.0, 1.0, 6.0, 6.0, 6.0] + calm(10))


def _feed(pkg, ratios, tier="gpu_net:off-node", machine="summit", nbytes=65536.0):
    core, obs, health = pkg
    spec = core.get_machine(machine)
    t_model = float(spec.tiers[tier].time(nbytes))
    seen = []
    health.monitor().on_transition(lambda lk, old, new: seen.append((lk.key, old, new)))
    states = []
    for r in ratios:
        obs.drift.record(machine, tier, "probe", nbytes, t_model, r * t_model)
        lk = health.monitor().link(machine, tier)
        states.append((lk.state, lk.detector.consecutive, lk.consecutive_normal,
                       lk.detection_records, lk.last_ratio, lk.detector.ewma))
    return seen, states


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("metrics_on", [False, True])
def test_health_stream_matches_reference(seed, metrics_on):
    """One drift stream into both monitors: the same state, streaks and
    detector baseline after every record, the same transitions, snapshot
    JSON and ``health.*`` metrics."""
    ratios = _ratio_stream(seed)
    out = []
    for core, obs, health in BOTH:
        if metrics_on:
            obs.metrics.enable()
        tracer = obs.trace.start("health")
        seen, states = _feed((core, obs, health), ratios)
        obs.trace.stop()
        names = [(e["ph"], e["name"], e.get("args")) for e in tracer.events if e["ph"] != "M"]
        out.append((seen, states, health.monitor().snapshot(), shared_metrics(obs.metrics),
                    names))
    (rs, rst, rsnap, rm, rn), (ts, tst, tsnap, tm, tn) = out
    assert any(new == "degraded" for _, _, new in rs) and len(rs) >= 4
    assert ts == rs
    same(rst, tst)
    assert json.dumps(tsnap, sort_keys=True) == json.dumps(rsnap, sort_keys=True)
    assert tm == rm and (bool(rm) == metrics_on)
    assert tn == rn and any(ph == "b" for ph, _, _ in rn)


def test_health_config_and_transition_table_match_reference():
    same(r_health.HealthConfig(), t_health.HealthConfig())
    assert t_health.TRANSITIONS == r_health.TRANSITIONS
    cfg = dict(ratio_threshold=1.2, ewma_alpha=0.3, warmup=2, suspect_after=1,
               degrade_after=2, recover_after=2, history=8)
    seen = []
    for core, obs, health in BOTH:
        health.reset(health.HealthConfig(**cfg))
        got, states = _feed((core, obs, health), _ratio_stream(2))
        seen.append((got, states, health.monitor().snapshot()))
        assert health.monitor().links[("summit", "gpu_net:off-node")].samples.maxlen == 8
    assert seen[0][0] == seen[1][0]
    same(seen[0][1], seen[1][1])
    assert json.dumps(seen[0][2], sort_keys=True) == json.dumps(seen[1][2], sort_keys=True)


@pytest.mark.parametrize("kw", [{}, dict(base_machine="lassen", sag=6.0),
                                dict(nbytes=float(1 << 20), n_msgs=2, sag=20.0)])
def test_degradation_drill_matches_reference(kw):
    """The synthetic drill's evidence dict, key by key, and what it leaves in
    each package's registry and plan cache."""
    for core, obs, health in BOTH:
        obs.metrics.enable()
    r_ev = r_health.degradation_drill(**kw)
    t_ev = t_health.degradation_drill(**kw)
    assert r_ev["detected"] and (r_ev["replanned_beats_stale"] or kw)
    same(r_ev, t_ev)
    assert r_core.get_machine("obs_drill").fingerprint == t_core.get_machine("obs_drill").fingerprint
    assert t_autotune.plan_cache_info() == r_autotune.plan_cache_info()
    assert shared_metrics(t_metrics) == shared_metrics(r_metrics)
    same(r_health.monitor().snapshot(), t_health.monitor().snapshot())


def test_health_cli_matches_reference(tmp_path, capsys):
    """``--drill --json --out``, then ``--load`` of what it wrote, in both
    packages: the same JSON and the same report."""
    outs = {}
    for name, health in (("r", r_health), ("t", t_health)):
        path = tmp_path / f"{name}.json"
        assert health.main(["--drill", "--json", "--out", str(path)]) == 0
        printed = json.loads(capsys.readouterr().out)
        assert printed == json.loads(path.read_text())
        assert health.main(["--load", str(path)]) == 0
        outs[name] = (printed, capsys.readouterr().out)
    assert outs["t"][0] == outs["r"][0]
    assert outs["t"][1] == outs["r"][1] and "  drill:" not in outs["t"][1]
    t_obs.reset_all()
    assert t_health.main(["--drill"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_refit_degraded_and_replan_match_reference():
    """``refit_degraded`` from a degraded link registers the same variant;
    ``request_replan`` without a spec empties both plan caches."""
    out = []
    for (core, obs, health), autotune in zip(BOTH, (r_autotune, t_autotune)):
        obs.metrics.enable()
        _feed((core, obs, health), [1.0] * 4 + [9.0] * 4, tier="dcn", machine="tpu_v5e",
              nbytes=float(1 << 20))
        lk = health.monitor().link("tpu_v5e", "dcn")
        assert lk.state == "degraded"
        fit, spec = health.refit_degraded(core.get_machine("tpu_v5e"), lk, register_as="tpu_v5e")
        autotune.select_schedule("summit", 4096.0, 4)
        health.request_replan(reason="straggler")
        out.append((fit, spec.fingerprint, core.get_machine("tpu_v5e").fingerprint,
                    autotune.plan_cache_info(), health.monitor().replans,
                    shared_metrics(obs.metrics)))
    same(out[0], out[1])
    assert out[0][3]["entries"] == 0 and out[0][1] == out[0][2]


# -- congestion ----------------------------------------------------------------

@pytest.mark.parametrize("machine,tier", [("summit", "gpu_net:off-node"), ("tpu_v5e", "dcn"),
                                          ("lassen", "copy_h2d:on-socket")])
def test_congestion_fits_match_reference(machine, tier):
    """``fit_degraded_tier`` and ``apply_degradation`` on a seeded sagged
    sample set, at rel 0; the variant's fingerprint and description."""
    rng = np.random.default_rng(3)
    sizes = [float(2 ** k) for k in range(6, 24, 2)]
    spec = r_core.get_machine(machine)
    times = [float(spec.tiers[tier].time(s)) * (7.5 + 0.1 * rng.standard_normal())
             + 2e-6 * rng.random() for s in sizes]
    r_fit = r_congestion.fit_degraded_tier(machine, tier, sizes, times)
    t_fit = t_congestion.fit_degraded_tier(machine, tier, sizes, times)
    same(r_fit, t_fit)
    r_spec = r_congestion.apply_degradation(machine, {tier: r_fit}, register_as="cong_probe")
    t_spec = t_congestion.apply_degradation(machine, {tier: t_fit}, register_as="cong_probe")
    assert r_spec.fingerprint == t_spec.fingerprint != spec.fingerprint
    assert r_spec.description == t_spec.description
    same(r_spec.tiers[tier].time(np.asarray(sizes)), t_spec.tiers[tier].time(np.asarray(sizes)))
    with pytest.raises(ValueError, match="no samples"):
        t_congestion.fit_degraded_tier(machine, tier, [], [])


@pytest.mark.parametrize("machine,tier,nbytes", [("summit", "gpu_net:off-node", 65536.0),
                                                 ("tpu_v5e", "ici", float(1 << 20))])
def test_contention_fit_matches_reference(machine, tier, nbytes):
    """``predict_concurrent`` at every capacity, and ``fit_contention`` on a
    measured sweep made from capacity 2 with a sag, with its drift records."""
    lanes = [1, 2, 3, 4, 6, 8]
    for cap in (None, 1, 2, 5):
        for k in lanes:
            same(r_congestion.predict_concurrent(machine, tier, nbytes, k, capacity=cap,
                                                 beta_scale=1.3),
                 t_congestion.predict_concurrent(machine, tier, nbytes, k, capacity=cap,
                                                 beta_scale=1.3))
    measured = [1.1 * r_congestion.predict_concurrent(machine, tier, nbytes, k, capacity=2)
                for k in lanes]
    r_fit = r_congestion.fit_contention(machine, tier, nbytes, lanes, measured)
    t_fit = t_congestion.fit_contention(machine, tier, nbytes, lanes, measured)
    same(r_fit, t_fit)
    assert t_fit.capacity_overrides == r_fit.capacity_overrides
    same(r_obs.drift.records(), t_obs.drift.records())
    with pytest.raises(ValueError, match="align"):
        t_congestion.fit_contention(machine, tier, nbytes, [1, 2], [1.0])


# -- traces ---------------------------------------------------------------------

def _schedules(core):
    """A few engine results: every candidate of one problem on two machines."""
    out = []
    for machine, nbytes, n in (("summit", 65536.0, 8), ("tpu_v5e", float(1 << 20), 4)):
        spec = core.get_machine(machine)
        for name, sched in sorted(core.schedule.candidate_schedules(spec, nbytes, n).items()):
            out.append(core.events.run_schedule(sched))
    return out


@pytest.mark.parametrize("include_report", [False, True])
def test_schedule_events_match_reference(include_report):
    """``schedule_events`` (lanes, queue waits, blocker flows, critical path)
    and ``to_chrome_json`` for the same results, event by event."""
    rs, ts = _schedules(r_core), _schedules(t_core)
    assert len(rs) == len(ts) >= 6
    for r, t in zip(rs, ts):
        same(r_trace._assign_lanes(r), t_trace._assign_lanes(t))
        re_, rm, rn = r_trace.schedule_events(r, 3, flow_id0=5, include_report=include_report)
        te, tm, tn = t_trace.schedule_events(t, 3, flow_id0=5, include_report=include_report)
        assert te == re_ and rn == tn
        same(rm, tm)
        rc = r_trace.to_chrome_json(r, include_report=include_report)
        tc = t_trace.to_chrome_json(t, include_report=include_report)
        assert json.dumps(tc, sort_keys=True) == json.dumps(rc, sort_keys=True)


def test_tracer_records_schedules_through_the_sink():
    """An active tracer (``record_schedules`` on) and metrics: the engine sink
    installs, every ``run_schedule`` result becomes its own pid with the
    reference's events, and ``engine.*`` counters match; with
    ``record_schedules`` off nothing is recorded; stopping and disabling
    removes the sink."""
    out = []
    for core, obs, _ in BOTH:
        assert core.events._OBS_SINK is None
        tracer = obs.trace.start("sink", record_schedules=True)
        assert obs.trace.is_active() and obs.trace.active() is tracer
        assert core.events._OBS_SINK is not None
        obs.metrics.enable()
        _schedules(core)
        obs.trace.instant("mark", at=1)
        iid = obs.trace.begin_interval("window", cat="elastic", step=2)
        obs.trace.end_interval("window", iid, cat="elastic")
        obs.trace.stop()
        sim = [(e["ph"], e["pid"], e["tid"], e["name"], e.get("ts"), e.get("dur"), e.get("args"))
               for e in tracer.events if e["pid"] != 0]
        marks = [(e["ph"], e["name"], e.get("cat"), e.get("id"), e.get("args"))
                 for e in tracer.events if e["pid"] == 0]
        out.append((sim, marks, tracer.metadata, shared_metrics(obs.metrics)))
        obs.metrics.disable()
        assert core.events._OBS_SINK is None
        quiet = obs.trace.start("quiet", record_schedules=False)
        _schedules(core)
        assert obs.trace.stop() is quiet and len(quiet.events) == 1
        assert obs.trace.record_schedule(_schedules(core)[0]) is None  # no tracer
    (rs, rm, rmeta, rc), (ts, tm, tmeta, tc) = out
    assert ts == rs and len(rs) > 50
    assert tm == rm
    same(rmeta, tmeta)
    assert tc == rc and tc["engine.runs"] == len(_schedules(t_core))


# -- observed, metrics ------------------------------------------------------------

def test_observed_counts_like_reference():
    """``observed`` selectors: calls, pick counters and latency histogram
    counts equal; off, the wrapper records nothing."""
    out = []
    for core, obs, _ in BOTH:
        autotune = r_autotune if obs is r_obs else t_autotune
        autotune.select_schedule("summit", 4096.0, 4)
        assert obs.metrics.to_json()["counters"] == {}
        obs.metrics.enable()
        for nbytes in (64.0, 4096.0, 4096.0, float(1 << 20)):
            autotune.select_collective_strategy("lassen", nbytes, 8)
            autotune.select_transfer_path("summit", nbytes)
        snap = obs.metrics.to_json()
        out.append((snap["counters"], {k: h["count"] for k, h in snap["histograms"].items()}))
        assert autotune.select_schedule.__wrapped__ is not autotune.select_schedule
    assert out[0] == out[1]
    assert out[1][0]["plan.select_transfer_path.calls"] == 4


def test_metrics_api_matches_reference():
    """enable/disable/reset/swap_registry/dump/summary_line/to_json."""
    texts = []
    for m in (r_metrics, t_metrics):
        assert not m.enabled()
        m.inc("a.x")  # off: nothing
        m.enable()
        assert m.enabled()
        m.inc("a.x", 2)
        m.gauge("a.g", 3.5)
        for v in (0.0, 1e-6, 3e-3, 2.0):
            m.observe("a.h.seconds", v)
        old = m.swap_registry()
        m.inc("b.y")
        fresh = m.swap_registry(old)
        assert list(fresh.counters) == ["b.y"]
        texts.append((m.dump(), m.summary_line(prefixes=["a."]), m.to_json()))
        m.disable()
        assert not m.enabled() and m.to_json()["counters"] == {"a.x": 2.0}
        m.reset()
        assert m.to_json()["counters"] == {}
    assert texts[0] == texts[1]


def test_reset_all_returns_to_cold_state():
    for core, obs, health in BOTH:
        obs.metrics.enable()
        obs.trace.start()
        obs.drift.record("summit", "gpu_net:off-node", "probe", 1.0, 1.0, 9.0)
        assert health.monitor().links
        obs.reset_all()
        assert not obs.metrics.enabled() and not obs.trace.is_active()
        assert obs.drift.records() == [] and health.monitor().links == {}
        assert core.events._OBS_SINK is None

"""Serve's per-step planner consult and its failure drills, the port's
``repro_torch.launch.serve.main`` against the JAX package's
``repro.launch.serve.main`` on the CPU.

Both serve llama3.2-1b at smoke width (batch 2, prompt 8, 12 new tokens)
five ways: no drill, the degradation drill, a host loss shrunk, a host loss
shed, and a seeded scenario.  The drills are host code: the same printed
drill lines and per-step plan, the same ``plan_cache.*``,
``lowering_memo.*``, ``engine.*``, ``health.*`` and ``runtime.*`` metrics,
the same ``serve.decode.tokens``, ``serve.batch.live`` and
``serve.simulated_makespan_s`` (to the float), the same ``--health-out``
JSON, the same simulated-lane and drill events in the trace, and the same
-1 layout of the shed row.  The tokens themselves come from each package's
own random weights and are not compared here (``test_torch_serve.py``
holds the models on shared weights).
"""
import json
import re

import numpy as np
import pytest

import repro.launch.serve as r_serve
import repro.runtime.scenarios as r_sc
import repro_torch.launch.serve as t_serve
from _torch_obs_parity import (  # noqa: F401  (the fixture is autouse)
    _fresh_planners,
    fresh_both,
    r_obs,
    shared_metrics,
    t_obs,
)

BASE = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--prompt-len", "8",
        "--new-tokens", "12"]
WAYS = {"plain": [], "degrade": ["--degrade-at", "3"],
        "shrink": ["--fail-at", "6", "--fail-mode", "shrink"],
        "shed": ["--fail-at", "6", "--fail-mode", "shed"],
        "scenario": ["--scenario", "{scenario}"]}
DRILL_LINE = re.compile(r"^\[serve\] (link|host|scenario|per-step plan)")
SERVE_METRICS = ("serve.decode.tokens", "serve.batch.live", "serve.simulated_makespan_s")


def _serve(main, obs, argv, tmp_path, name, capsys):
    trace_path, health_path = tmp_path / f"{name}.trace.json", tmp_path / f"{name}.health.json"
    gen = main(argv + ["--trace", str(trace_path), "--health-out", str(health_path)])
    out = capsys.readouterr().out
    snap = obs.metrics.to_json()
    metrics = shared_metrics(obs.metrics)
    metrics.update({k: v for kind in ("counters", "gauges") for k, v in snap[kind].items()
                    if k in SERVE_METRICS})
    events = json.loads(trace_path.read_text())["traceEvents"]
    sim = [(e["ph"], e["pid"], e["tid"], e["name"], e.get("cat"), e.get("ts"), e.get("dur"),
            e.get("args")) for e in events if e["pid"] != 0]
    marks = [(e["ph"], e["name"], e.get("cat"), e.get("args")) for e in events
             if e["pid"] == 0 and e["ph"] in ("b", "e", "i")]
    return {"gen": np.asarray(gen), "lines": [ln for ln in out.splitlines() if DRILL_LINE.match(ln)],
            "metrics": metrics, "health": json.loads(health_path.read_text()), "sim": sim,
            "marks": marks}


@pytest.mark.parametrize("way", list(WAYS))
def test_serve_drills_match_reference(way, tmp_path, capsys):
    scenario = tmp_path / "scenario.json"
    r_sc.generate(3, 12, hosts=4, n_events=4, tiers=("dcn",)).save(str(scenario))
    argv = BASE + [a.format(scenario=scenario) for a in WAYS[way]]
    ref = _serve(r_serve.main, r_obs, argv, tmp_path, "ref", capsys)
    fresh_both()
    port = _serve(t_serve.main, t_obs, argv + ["--device", "cpu"], tmp_path, "port", capsys)
    assert port["lines"] == ref["lines"]
    assert port["metrics"] == ref["metrics"]
    assert port["health"] == ref["health"]
    assert port["sim"] == ref["sim"] and ref["sim"]
    assert port["marks"] == ref["marks"]
    assert port["gen"].shape == ref["gen"].shape == (2, 12)
    assert np.array_equal(port["gen"] == -1, ref["gen"] == -1)
    want = {"plain": ["[serve] per-step plan: flat"],
            "degrade": ["[serve] link tpu_v5e/dcn degraded at decode step 5 (detected in 3 "
                        "records); refit beta x11.7, replanning", "[serve] per-step plan: flat"],
            "shrink": ["[serve] host 0 lost at decode step 6; shrunk 'tpu_v5e' to 63 ranks "
                       "(fingerprint 3a9910f678af), replanning", "[serve] per-step plan: flat"],
            "shed": ["[serve] host 0 lost at decode step 6; shed one sequence (batch 2 -> 1)",
                     "[serve] per-step plan: flat"],
            "scenario": ["[serve] scenario 'generated-3' (seed 3): 4 events",
                         "[serve] host 3 lost at decode step 2; shrunk 'tpu_v5e' to 63 ranks "
                         "(fingerprint 3a9910f678af), replanning",
                         "[serve] per-step plan: flat"]}[way]
    assert port["lines"] == want
    tokens = port["metrics"]["serve.decode.tokens"]
    if way == "shed":
        assert tokens == 18 and port["metrics"]["serve.batch.live"] == 1
        assert (port["gen"][1, 7:] == -1).all() and (port["gen"][1, :7] >= 0).all()
        assert (port["gen"][0] >= 0).all()
    else:
        assert tokens == 24 and (port["gen"] >= 0).all()
    if way == "degrade":
        assert port["metrics"]["health.links.degraded"] == 1
        assert f"{port['metrics']['serve.simulated_makespan_s']:g}" == "3.27378e-05"


def test_run_takes_the_drill_flags(tmp_path, capsys):
    """``run`` with the flags as keywords serves as ``main`` does; an unknown
    ``fail_mode`` is refused."""
    import repro_torch.configs as tcfgs

    gen = t_serve.main(BASE + ["--device", "cpu", "--degrade-at", "2", "--fail-at", "4",
                               "--fail-mode", "shed"])
    first = capsys.readouterr().out
    fresh_both()
    again = t_serve.run(tcfgs.smoke_config("llama3.2-1b"), batch=2, prompt_len=8, new_tokens=12,
                        seed=0, device="cpu", degrade_at=2, fail_at=4, fail_mode="shed")
    second = capsys.readouterr().out
    assert np.array_equal(gen, again)
    pick = lambda text: [ln for ln in text.splitlines() if DRILL_LINE.match(ln)]  # noqa: E731
    assert pick(first) == pick(second) and len(pick(first)) == 3
    with pytest.raises(ValueError, match="fail_mode"):
        t_serve.run(tcfgs.smoke_config("llama3.2-1b"), batch=2, prompt_len=8, new_tokens=2,
                    seed=0, device="cpu", fail_mode="drop")


def test_consult_reads_nothing_from_the_device(monkeypatch, capsys):
    """The per-step consult is host code: every call gets the plan shape and
    a float payload that grows with the live KV length, never a tensor."""
    seen = []
    real = t_serve.select_allreduce_strategy

    def spy(shape, nbytes, *a, **k):
        seen.append((dict(shape), nbytes))
        return real(shape, nbytes, *a, **k)

    monkeypatch.setattr(t_serve, "select_allreduce_strategy", spy)
    t_serve.main(BASE + ["--device", "cpu"])
    capsys.readouterr()
    import repro_torch.configs as tcfgs

    d = tcfgs.smoke_config("llama3.2-1b").d_model
    assert seen == [({"data": 1, "model": 1}, float(2 * d) * 2 * (8 + i + 1)) for i in range(12)]
    assert all(type(n) is float for _, n in seen)

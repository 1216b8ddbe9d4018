"""The port's simlint (``repro_torch.analysis``) against the JAX package's
(``repro.analysis``) on the CPU: the ``lint --all --json`` reports, the spec
and fit-residual findings, the verifiers on the schedule surface, and strict
mode raising on the same broken schedule."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_core_parity import (  # noqa: F401  (the fixture is autouse)
    BUILTIN,
    _both_packages_fresh,
    r_analysis,
    r_core,
    same,
    t_analysis,
    t_core,
)

SRC = Path(__file__).resolve().parents[1] / "src"


def _lint_report(pkg: str, tmp_path: Path) -> tuple:
    out = tmp_path / f"{pkg}.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_STRICT_VALIDATION", None)
    run = subprocess.run([sys.executable, "-m", f"{pkg}.analysis.lint", "--all", "--json", str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    return run.returncode, run.stdout, json.loads(out.read_text())


def test_lint_all_json_reports_agree(tmp_path):
    r_rc, r_out, r_rep = _lint_report("repro", tmp_path)
    t_rc, t_out, t_rep = _lint_report("repro_torch", tmp_path)
    # each report names its own package's tool; every other key is equal
    assert r_rep.pop("tool") == "repro.analysis.lint"
    assert t_rep.pop("tool") == "repro_torch.analysis.lint"
    assert sorted(t_rep) == sorted(r_rep)
    for key in r_rep:
        assert t_rep[key] == r_rep[key], key
    assert (t_rc, t_out) == (r_rc, r_out)
    assert t_rep["clean"] and t_rep["schedules_checked"] > 0
    assert [m["machine"] for m in t_rep["machines"]] == list(BUILTIN)


@pytest.mark.parametrize("name", BUILTIN)
def test_lint_machine_in_process(name):
    from repro.analysis import lint as r_lint
    from repro_torch.analysis import lint as t_lint

    assert t_lint.lint_machine(name) == r_lint.lint_machine(name)


def _tiny(core, alpha=1e-6, beta=1e-11, width=2, provenance="measured"):
    tier = core.machine.TransportTier(
        "t", core.postal.SimplePostalModel(core.PostalParams(alpha, beta)), width=width)
    return core.MachineSpec(name="tiny", tiers={"t": tier}, paths={}, provenance=provenance)


def test_lint_spec_findings():
    for name in BUILTIN:
        same(r_analysis.lint_spec(r_core.get_machine(name)),
             t_analysis.lint_spec(t_core.get_machine(name)), where=name)
    for kw in (dict(alpha=1.0), dict(beta=1e-3), dict(width=64), dict(provenance="fitted"),
               dict(provenance="representative")):
        r_found = r_analysis.lint_spec(_tiny(r_core, **kw))
        t_found = t_analysis.lint_spec(_tiny(t_core, **kw))
        same(r_found, t_found, where=str(kw))
        assert [f.to_dict() for f in t_found] == [f.to_dict() for f in r_found]
    for core, analysis in ((r_core, r_analysis), (t_core, t_analysis)):
        assert analysis.sort_findings(analysis.lint_spec(_tiny(core, alpha=1.0)))
    for lost in (1, 2):
        same(r_analysis.lint_spec(r_core.machine.shrink_spec(r_core.get_machine("summit"), lost)),
             t_analysis.lint_spec(t_core.machine.shrink_spec(t_core.get_machine("summit"), lost)))


def test_check_fit_residuals():
    rng = np.random.default_rng(7)
    for name in ("summit", "lassen", "gh200"):
        r_spec, t_spec = r_core.get_machine(name), t_core.get_machine(name)
        measured = {}
        for key in list(r_spec.tiers)[:4]:
            sizes = (1024.0, 65536.0, float(1 << 20))
            scale = rng.choice([1.0, 1.2, 3.0, 0.1], size=3)
            measured[key] = [(s, float(r_spec.tiers[key].time(s)) * k) for s, k in zip(sizes, scale)]
        measured["no_such_tier"] = [(1024.0, 1e-6)]
        for tol in (0.5, 0.1):
            r_found = r_analysis.check_fit_residuals(r_spec, measured, rel_tol=tol)
            t_found = t_analysis.check_fit_residuals(t_spec, measured, rel_tol=tol)
            same(r_found, t_found, where=f"{name} {tol}")
            assert any(f.check == "spec.fit_residual" for f in t_found)
            assert any(f.check == "spec.fit_missing_tier" for f in t_found)


@pytest.mark.parametrize("name", BUILTIN)
def test_verifiers_on_candidates_and_results(name):
    for s, n in ((4096.0, 4), (float(1 << 20), 32)):
        r_cands = r_core.schedule.candidate_schedules(name, s, n)
        t_cands = t_core.schedule.candidate_schedules(name, s, n)
        for key in r_cands:
            same(r_analysis.verify(r_cands[key]), t_analysis.verify(t_cands[key]), where=key)
            same(r_analysis.declared_bytes(r_cands[key]), t_analysis.declared_bytes(t_cands[key]))
            same(r_analysis.verify_result(r_core.events.run_schedule(r_cands[key])),
                 t_analysis.verify_result(t_core.events.run_schedule(t_cands[key])), where=key)
        r_spec, t_spec = r_core.get_machine(name), t_core.get_machine(name)
        for strat in r_spec.strategies:
            r_s = r_core.schedule.lower_strategy(r_spec, strat, s, n)
            t_s = t_core.schedule.lower_strategy(t_spec, strat, s, n)
            # right size, then the wrong one: conservation must flag the latter
            for s_chk in (s, 2 * s):
                same(r_analysis.check_lowering(r_spec, strat, r_s, s_chk, n),
                     t_analysis.check_lowering(t_spec, strat, t_s, s_chk, n), where=strat)


def _aliased_parts(core) -> list:
    """A library schedule and a part that uses the bare tier name as its
    pool: composed, the contention verifier's error."""
    spec = core.get_machine("tpu_v5e")
    lib = core.schedule.ring_allgather_schedule(spec, "ici", 4, 4096.0)
    cap = lib.resources["ici.rank0"].capacity
    bare = core.events.Schedule(
        name="legacy",
        steps=(core.events.Step(name="x", duration=1.0, resources=("ici",), nbytes=8.0),),
        resources={"ici": core.events.Resource("ici", cap, tier="ici")},
    )
    return [bare, lib]


def test_strict_mode_raises_on_the_same_broken_schedule(monkeypatch):
    errs = []
    for core, analysis in ((r_core, r_analysis), (t_core, t_analysis)):
        with pytest.raises(analysis.ScheduleValidationError) as err:
            core.schedule.compose_schedules(None, _aliased_parts(core))
        errs.append(err.value)
    r_err, t_err = errs
    same(r_err.findings, t_err.findings)
    assert str(t_err) == str(r_err)
    assert any(f.check == "contention.aliased_pools" for f in t_err.findings)
    # the environment variable arms both when neither is forced; off, the
    # same composition builds in both
    for analysis in (r_analysis, t_analysis):
        analysis.set_strict(None)
    try:
        for value, on in (("1", True), ("off", False), ("", False), ("yes", True)):
            monkeypatch.setenv("REPRO_STRICT_VALIDATION", value)
            assert r_analysis.strict_enabled() is t_analysis.strict_enabled() is on, value
        monkeypatch.setenv("REPRO_STRICT_VALIDATION", "0")
        for core in (r_core, t_core):
            core.schedule.compose_schedules(None, _aliased_parts(core))
    finally:
        r_analysis.set_strict(True)

"""The port's fault-tolerant loop and host-loss drill
(``repro_torch.runtime.fault.run_with_recovery``, ``BackoffPolicy``,
``RecoveryExhausted``, ``runtime.elastic.host_drop_drill``) against the JAX
package's ``repro.runtime`` on the CPU, function by function.

The reference's toys (``tests/test_substrate.py``, ``tests/test_elastic.py``,
``tests/test_health.py``) run in both packages: the port's on tensors (0-d
float64 where the reference has numpy scalars), through the port's
``Checkpointer``.  The same final states, bit for bit; the same backoff
delays, to the float; the same ``RecoveryExhausted`` fields and message;
the same ``runtime.*`` and ``health.*`` counters; the same evidence dict
from ``host_drop_drill``.  Then smoke llama's ``train_step`` (which updates
its trees in place) under ``run_with_recovery``, through a fault before the
first checkpoint, a fault after it and a host loss, bit for bit a clean run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.elastic as r_elastic
import repro.runtime.fault as r_fault
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.runtime.straggler import StragglerMonitor as RMonitor
import repro_torch.runtime as t_runtime
import repro_torch.runtime.elastic as t_elastic
import repro_torch.runtime.fault as t_fault
from repro_torch.checkpoint import Checkpointer as TCheckpointer
from repro_torch.runtime.straggler import StragglerMonitor as TMonitor
from _torch_obs_parity import (  # noqa: F401  (the fixture is autouse)
    _fresh_planners,
    fresh_both,
    r_obs,
    shared_metrics,
    t_obs,
)

PACKAGES = {"ref": (r_fault, RCheckpointer, r_obs), "port": (t_fault, TCheckpointer, t_obs)}


def f64(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float64)


def scalar(pkg: str, x):
    return np.float64(x) if pkg == "ref" else f64(x)


def _counters(obs) -> dict:
    return obs.metrics.to_json()["counters"]


# -- the substrate toy: recovery is bitwise ------------------------------------

def _batch(pkg, step):
    x = np.random.default_rng(step).standard_normal(4).astype(np.float32)
    return {"x": jnp.asarray(x) if pkg == "ref" else torch.from_numpy(x)}


def _sum_step(params, opt, batch):
    x = batch["x"]
    total = x.sum()
    return {k: p + total for k, p in params.items()}, opt, {"loss": total}


@pytest.mark.parametrize("faults", [set(), {12}, {2, 12, 17}])
def test_recovery_is_bitwise_identical(tmp_path, faults):
    out = {}
    for pkg, (fault, Ckpt, _) in PACKAGES.items():
        pending = set(faults)

        def hook(step, pending=pending, fault=fault):
            if step in pending:
                pending.remove(step)
                raise fault.InjectedFault(f"node died at {step}")

        init = {"w": jnp.zeros(4)} if pkg == "ref" else {"w": torch.zeros(4)}
        state = fault.run_with_recovery(
            step_fn=_sum_step, batch_fn=lambda s, pkg=pkg: _batch(pkg, s), init_params=init,
            init_opt={}, checkpointer=Ckpt(str(tmp_path / pkg)), total_steps=20,
            checkpoint_every=5, fault_hook=hook)
        out[pkg] = (state.step, np.asarray(state.params["w"]))
    assert out["port"][0] == out["ref"][0] == 20
    assert np.array_equal(out["port"][1], out["ref"][1])


def test_a_restart_before_the_first_checkpoint_starts_from_the_initial_trees(tmp_path):
    """The port's trees may be updated in place: a restart with no checkpoint
    to restore starts again from the trees as they were given."""
    def step(params, opt, batch):
        params["w"].add_(1.0)
        opt["m"].add_(2.0)
        return params, opt, {}

    fired = []

    def hook(s):
        if s == 2 and not fired:
            fired.append(s)
            raise t_fault.InjectedFault("early")

    state = t_fault.run_with_recovery(
        step_fn=step, batch_fn=lambda s: {}, init_params={"w": f64(0)}, init_opt={"m": f64(0)},
        checkpointer=TCheckpointer(str(tmp_path)), total_steps=4, checkpoint_every=3,
        fault_hook=hook)
    assert float(state.params["w"]) == 4.0 and float(state.opt_state["m"]) == 8.0


# -- backoff ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(base=0.5, multiplier=2.0, max_delay=3.0, seed=42),
                                dict(base=0.01, max_delay=0.05, seed=7),
                                dict(base=1.0, multiplier=3.0, max_delay=10.0, jitter=0.0),
                                dict(base=0.2, jitter=1.0, seed=123)])
def test_backoff_delays_are_the_references(kw):
    ref, port = r_fault.BackoffPolicy(**kw), t_fault.BackoffPolicy(**kw)
    assert [port.delay(i) for i in range(1, 12)] == [ref.delay(i) for i in range(1, 12)]
    for bad in (dict(jitter=1.5), dict(multiplier=0.5), dict(base=-1.0)):
        with pytest.raises(ValueError) as want:
            r_fault.BackoffPolicy(**bad)
        with pytest.raises(ValueError) as got:
            t_fault.BackoffPolicy(**bad)
        assert str(got.value).replace("repro_torch", "repro") == str(want.value)
    with pytest.raises(ValueError, match="must be >= 1"):
        port.delay(0)


def _run_both(tmp_path, *, hook_for, per_pkg=lambda pkg: {}, **kw):
    """``run_with_recovery`` of a no-op step in both packages from fresh
    observability, with ``kw`` and ``per_pkg(pkg)``'s keywords; per package
    (the state or the exception raised, counters, histograms)."""
    out = {}
    for pkg, (fault, Ckpt, obs) in PACKAGES.items():
        fresh_both()
        obs.metrics.enable()
        try:
            res = fault.run_with_recovery(
                step_fn=lambda p, o, b: (p, o, {}), batch_fn=lambda s: {},
                init_params={"w": scalar(pkg, 0)}, init_opt={"m": scalar(pkg, 0)},
                checkpointer=Ckpt(str(tmp_path / pkg)), fault_hook=hook_for(fault),
                **kw, **per_pkg(pkg))
        except Exception as e:  # noqa: BLE001  (compared across the packages)
            res = e
        snap = obs.metrics.to_json()
        out[pkg] = (res, snap["counters"], snap["histograms"])
    return out


def test_recovery_exhausted_is_typed_and_counted(tmp_path):
    def hook_for(fault):
        def hook(step):
            if step == 2:
                raise fault.InjectedFault("always")
        return hook

    out = _run_both(tmp_path, hook_for=hook_for, total_steps=6, checkpoint_every=2,
                    max_restarts=3)
    ref, port = out["ref"][0], out["port"][0]
    assert isinstance(ref, r_fault.RecoveryExhausted)
    assert isinstance(port, t_fault.RecoveryExhausted) and isinstance(port, RuntimeError)
    assert (port.step, port.restarts) == (ref.step, ref.restarts) == (2, 3)
    assert isinstance(port.last_error, t_fault.InjectedFault)
    assert str(port) == str(ref) == ("recovery exhausted after 3 restart(s) at step 2: "
                                     "InjectedFault: always")
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1]["runtime.recovery.exhausted"] == 1.0
    assert out["port"][1]["runtime.restarts"] == 3.0


def test_backoff_delays_are_slept_and_observed(tmp_path):
    def hook_for(fault):
        faults = {1, 3}

        def hook(step):
            if step in faults:
                faults.remove(step)
                raise fault.InjectedFault("boom")
        return hook

    slept = {"ref": [], "port": []}
    out = _run_both(tmp_path, hook_for=hook_for, total_steps=5, checkpoint_every=2,
                    per_pkg=lambda pkg: dict(
                        backoff=PACKAGES[pkg][0].BackoffPolicy(base=0.2, multiplier=2.0,
                                                               max_delay=5.0, seed=7),
                        sleep_fn=slept[pkg].append))
    assert out["port"][0].step == out["ref"][0].step == 5
    assert slept["port"] == slept["ref"] == [
        t_fault.BackoffPolicy(base=0.2, max_delay=5.0, seed=7).delay(i) for i in (1, 2)]
    assert out["port"][2]["runtime.recovery.backoff_s"] == out["ref"][2]["runtime.recovery.backoff_s"]
    assert out["port"][1] == out["ref"][1]


def test_host_lost_routes_on_host_drop_hook(tmp_path):
    seen = {"ref": [], "port": []}

    def hook_for(fault):
        fired = []

        def hook(step):
            if step == 3 and not fired:
                fired.append(step)
                raise fault.HostLost(5)
        return hook

    out = _run_both(tmp_path, hook_for=hook_for, total_steps=6, checkpoint_every=2,
                    per_pkg=lambda pkg: dict(on_host_drop=lambda e, step: seen[pkg].append(
                        (e.host, step))))
    assert out["port"][0].step == 6 and seen["port"] == seen["ref"] == [(5, 3)]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1]["runtime.elastic.host_drops"] == 1.0
    assert out["port"][1]["runtime.restarts"] == 1.0


def _sgd_step(params, opt, batch):
    g = params["w"] - batch["target"]
    m = 0.9 * opt["m"] + g
    return {"w": params["w"] - 0.1 * m}, {"m": m}, {}


def test_resume_restores_optimizer_state_from_checkpoint(tmp_path):
    """The reference's regression: a second process resumes with other live
    trees; both the weights and the momentum come from the checkpoint, and
    both packages end on the same floats."""
    got = {}
    for pkg, (fault, Ckpt, _) in PACKAGES.items():
        batch_fn = lambda s, pkg=pkg: {"target": scalar(pkg, s % 3)}  # noqa: E731
        ck = Ckpt(str(tmp_path / pkg / "run"))
        full = fault.run_with_recovery(
            step_fn=_sgd_step, batch_fn=batch_fn, init_params={"w": scalar(pkg, 0.0)},
            init_opt={"m": scalar(pkg, 0.0)}, checkpointer=Ckpt(str(tmp_path / pkg / "ref")),
            total_steps=8, checkpoint_every=4)

        def die(s, fault=fault):
            if s == 6:
                raise fault.InjectedFault("die")

        with pytest.raises(fault.RecoveryExhausted):
            fault.run_with_recovery(
                step_fn=_sgd_step, batch_fn=batch_fn, init_params={"w": scalar(pkg, 0.0)},
                init_opt={"m": scalar(pkg, 0.0)}, checkpointer=ck, total_steps=8,
                checkpoint_every=4, fault_hook=die, max_restarts=0)
        logs = []
        resumed = fault.run_with_recovery(
            step_fn=_sgd_step, batch_fn=batch_fn, init_params={"w": scalar(pkg, 123.0)},
            init_opt={"m": scalar(pkg, -7.0)}, checkpointer=ck, total_steps=8,
            checkpoint_every=4, log=logs.append)
        assert resumed.step == full.step == 8 and logs == ["resumed from step 4"]
        assert float(resumed.params["w"]) == float(full.params["w"])
        assert float(resumed.opt_state["m"]) == float(full.opt_state["m"])
        got[pkg] = (float(full.params["w"]), float(full.opt_state["m"]))
    assert got["port"] == got["ref"]


def test_straggler_mitigation_routes_one_replan(tmp_path, monkeypatch):
    """The reference's straggler test on a clock that only the steps move
    (its own times a sleep and flakes now and then): the same flags, one
    mitigation advisory, one ``request_replan(reason="straggler")``, the same
    log, in both packages."""
    slow = {6, 7, 8, 9}
    out = {}
    for pkg, (fault, Ckpt, obs) in PACKAGES.items():
        fresh_both()
        obs.metrics.enable()
        clock = [0.0]
        monkeypatch.setattr(fault.time, "perf_counter", lambda clock=clock: clock[0])

        def step_fn(params, opt, batch, clock=clock):
            clock[0] += 0.03 if batch["step"] in slow else 0.001
            return params, opt, {}

        faults = {3}

        def hook(step, fault=fault):
            if step in faults:
                faults.remove(step)
                raise fault.InjectedFault("boom")

        Monitor = RMonitor if pkg == "ref" else TMonitor
        logs = []
        state = fault.run_with_recovery(
            step_fn=step_fn, batch_fn=lambda s: {"step": s}, init_params={}, init_opt={},
            checkpointer=Ckpt(str(tmp_path / pkg)), total_steps=12, checkpoint_every=4,
            fault_hook=hook, monitor=Monitor(warmup_steps=3, consecutive_for_action=2),
            log=logs.append)
        out[pkg] = (state.step, _counters(obs), logs,
                    [r["reason"] for r in obs.health.monitor().replans])
        monkeypatch.undo()
    assert out["port"] == out["ref"]
    step, counters, logs, replans = out["port"]
    assert step == 12 and counters["runtime.straggler.mitigate"] == 1.0
    assert counters["health.replan.straggler"] == 1.0 and replans == ["straggler"]
    assert any(ln.startswith("straggler mitigation advised at step") for ln in logs)


# -- the drill -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(drop_hosts=(3,), drop_at=2, seed=5),
                                dict(total_ranks=24, drop_hosts=(20, 21, 22), drop_at=5,
                                     checkpoint_every=3, seed=1)])
def test_host_drop_drill_evidence_is_the_references(kw):
    for obs in (r_obs, t_obs):
        obs.metrics.enable()
    want = r_elastic.host_drop_drill(machine="t_recovery_drill", **kw)
    got = t_elastic.host_drop_drill(machine="t_recovery_drill", **kw)
    assert got == want
    assert got["survived"] and got["loss_continuity"] and got["fingerprint_changed"]
    assert shared_metrics(t_obs.metrics) == shared_metrics(r_obs.metrics)
    again = t_runtime.host_drop_drill(machine="t_recovery_drill", **kw)
    for key in ("stale_pick", "fresh_pick", "survivors", "speedup", "backoff_delays",
                "scenario", "t_stale_on_shrunk", "t_fresh_on_shrunk"):
        assert again[key] == got[key], key


# -- a model under the loop ----------------------------------------------------

def test_train_step_recovers_bitwise(tmp_path):
    """Smoke llama (f32) trained 7 steps under ``run_with_recovery``, every
    2 steps checkpointed: a fault at step 1 (before any checkpoint), one at
    step 3 and a host loss at step 6 (routed through ``shrink_and_replan``
    with a seeded backoff) end on the clean run's parameters and moments,
    bit for bit."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.machine import get_machine, register_machine
    from repro_torch.data import SyntheticLM
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import init_state

    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    run = RunConfig(model=cfg, seq_len=16, global_batch=4, warmup_steps=2, total_steps=7)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)

    def step_fn(p, o, b):
        return train_step(cfg, run, p, o, b)

    def batch_fn(s):
        return {"tokens": torch.from_numpy(data.batch(s)["tokens"])}

    def fresh():
        p = init_params(cfg, torch.Generator().manual_seed(0))
        return p, init_state(p)

    p, o = fresh()
    for s in range(7):
        p, o, _ = step_fn(p, o, batch_fn(s))
    base = get_machine("summit")
    register_machine("t_recovery_llama", dataclasses.replace(
        base, name="t_recovery_llama", facts={**base.facts, "n_gpus": 12, "ppn": 6}))
    faults = {1: t_fault.InjectedFault("early"), 3: t_fault.InjectedFault("late"),
              6: t_fault.HostLost(11)}

    def hook(s):
        if s in faults:
            raise faults.pop(s)

    drops, delays = [], []
    p0, o0 = fresh()
    state = t_runtime.run_with_recovery(
        step_fn=step_fn, batch_fn=batch_fn, init_params=p0, init_opt=o0,
        checkpointer=TCheckpointer(str(tmp_path), keep=2), total_steps=7, checkpoint_every=2,
        fault_hook=hook, backoff=t_fault.BackoffPolicy(base=0.01, seed=3),
        sleep_fn=delays.append,
        on_host_drop=lambda e, s: drops.append(
            t_elastic.shrink_and_replan("t_recovery_llama", [e.host]).facts["n_gpus"]))
    assert state.step == 7 and drops == [11] and not faults
    assert delays == [t_fault.BackoffPolicy(base=0.01, seed=3).delay(i) for i in (1, 2, 3)]
    assert int(state.opt_state.step) == int(o.step) == 7
    for name, got, want in (("params", state.params, p), ("mu", state.opt_state.mu, o.mu),
                            ("nu", state.opt_state.nu, o.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w), name


def test_runtime_exports_every_reference_name():
    import repro.runtime as rr

    assert {k for k in dir(rr) if not k.startswith("_")} <= set(dir(t_runtime))


def test_chip_smoke_holds_the_cpu_drill_evidence():
    """``chip_smoke.py`` phase 13 holds the card's ``host_drop_drill()`` to
    this evidence: its sha256 over the sorted JSON and its decision fields,
    as this CPU computes them (the script is read, not imported)."""
    import ast
    import hashlib
    import json
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id in ("DRILL_EVIDENCE", "DRILL_EVIDENCE_SHA")}
    ev = t_runtime.host_drop_drill()
    assert hashlib.sha256(json.dumps(ev, sort_keys=True).encode()).hexdigest() == \
        consts["DRILL_EVIDENCE_SHA"]
    assert {k: ev[k] for k in consts["DRILL_EVIDENCE"]} == consts["DRILL_EVIDENCE"]


def test_no_docstring_says_recovery_is_missing():
    """The modules this slice completed no longer say that recovery,
    reshard-on-restore or the drills under a mesh are not ported."""
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for rel in ("checkpoint/checkpointer.py", "runtime/fault.py", "runtime/elastic.py",
                "runtime/scenarios.py", "launch/serve.py", "launch/train.py"):
        text = (src / rel).read_text()
        for stale in ("not ported yet", "waits for reshard-on-restore", "they are refused",
                      "no counterpart until distribution"):
            assert stale not in text, (rel, stale)

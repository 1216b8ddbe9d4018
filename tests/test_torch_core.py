"""The port's cost models, registry, planner, event engine, fitter and
measurement loop (``repro_torch.core``, ``repro_torch.obs.drift``) against the
JAX package's (``repro.core``, ``repro.obs.drift``) on the CPU.

Both are the same numpy code in the same order, so every float is compared
exactly (``same`` with ``rel=0``).  The host -> device timer is the one
function that differs: the port times a torch copy, on the card by default.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from _torch_core_parity import (  # noqa: F401  (the fixture is autouse)
    BUILTIN,
    COUNTS,
    SIZES,
    _both_packages_fresh,
    r_core,
    r_drift,
    same,
    t_core,
    t_drift,
)


@pytest.mark.parametrize("name", BUILTIN)
def test_registry_machine_and_tiers(name):
    assert name in r_core.registered_machines() and name in t_core.registered_machines()
    r_spec, t_spec = r_core.get_machine(name), t_core.get_machine(name)
    same(r_spec, t_spec)
    assert r_spec.fingerprint == t_spec.fingerprint
    probe = np.asarray(r_core.machine._PROBE_SIZES)
    same(r_core.machine._PROBE_SIZES, t_core.machine._PROBE_SIZES)
    for key in r_spec.tiers:
        same(r_spec.tiers[key].time(probe), t_spec.tiers[key].time(probe), where=key)
        for s in r_core.machine._PROBE_SIZES:
            same(r_spec.tiers[key].postal_terms(s, 4.0), t_spec.tiers[key].postal_terms(s, 4.0))


@pytest.mark.parametrize("name", BUILTIN)
def test_closed_form_costs(name):
    r_spec, t_spec = r_core.get_machine(name), t_core.get_machine(name)
    s_grid, n_grid = np.meshgrid(np.asarray(SIZES), np.asarray(COUNTS), indexing="ij")
    for r_loc, t_loc in zip(r_core.Locality, t_core.Locality):
        for s in SIZES:
            for n in COUNTS:
                same(r_core.plan_costs(r_spec, s, n, locality=r_loc),
                     t_core.plan_costs(t_spec, s, n, locality=t_loc))
                same(r_core.simulate_strategies(r_spec, s, n, locality=r_loc),
                     t_core.simulate_strategies(t_spec, s, n, locality=t_loc))
        for path in r_spec.paths:
            for lanes in (1, 4):
                same(r_core.path_time(r_spec, path, s_grid, n_grid, lanes=lanes, locality=r_loc),
                     t_core.path_time(t_spec, path, s_grid, n_grid, lanes=lanes, locality=t_loc),
                     where=path)
        for strat in r_spec.strategies:
            for split in (False, True):
                same(r_core.strategy_time(r_spec, strat, s_grid, n_grid, locality=r_loc,
                                          split_messages=split),
                     t_core.strategy_time(t_spec, strat, s_grid, n_grid, locality=t_loc,
                                          split_messages=split), where=strat)


def test_fig5_crossovers():
    for topo, want in (("SUMMIT", 7), ("LASSEN", 45)):
        r = r_core.message_count_crossover(getattr(r_core.topology, topo), 1024.0)
        t = t_core.message_count_crossover(getattr(t_core.topology, topo), 1024.0)
        assert r == t == want, (topo, r, t)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_planner_entries(arch):
    """Every planner entry of ``core.__all__`` on the same problems; the MoE
    dispatch at the widths of the port's own configs."""
    for pkg in (r_core, t_core):
        assert {"plan_messages", "plan_gpu_messages", "plan_gpu_collective",
                "plan_schedule_search", "schedule_search_report", "plan_tpu_allreduce",
                "plan_tpu_crosspod", "plan_moe_alltoall", "message_count_crossover",
                "search_schedules", "simulate_schedule", "crossover_size"} <= set(pkg.__all__)
    for topo in ("SUMMIT", "LASSEN"):
        rt, tt = getattr(r_core.topology, topo), getattr(t_core.topology, topo)
        for s, n in ((1024.0, 1), (1024.0, 64), (65536.0, 4), (float(1 << 20), 32)):
            same(r_core.plan_gpu_messages(rt, s, n), t_core.plan_gpu_messages(tt, s, n))
        for r_kind, t_kind in zip(r_core.CollectiveKind, t_core.CollectiveKind):
            same(r_core.plan_gpu_collective(rt, 4, 65536.0, r_kind),
                 t_core.plan_gpu_collective(tt, 4, 65536.0, t_kind))
        same(r_core.message_count_crossover(rt, 4096.0, cores_per_gpu=4),
             t_core.message_count_crossover(tt, 4096.0, cores_per_gpu=4))
    for name in BUILTIN:
        for s, n in ((4096.0, 4), (65536.0, 32)):
            same(r_core.plan_messages(name, s, n), t_core.plan_messages(name, s, n))
            same(r_core.plan_schedule_search(name, s, n), t_core.plan_schedule_search(name, s, n))
            same(r_core.schedule_search_report(name, s, n),
                 t_core.schedule_search_report(name, s, n))
            strat = next(iter(r_core.get_machine(name).strategies))
            same(r_core.simulate_schedule(name, strat, s, n),
                 t_core.simulate_schedule(name, strat, s, n))
    r_gpu = r_core.get_machine("summit").tiers["gpu_net:off-node"].model
    t_gpu = t_core.get_machine("summit").tiers["gpu_net:off-node"].model
    r_cpu = r_core.get_machine("summit").tiers["cpu_net:off-node"].model
    t_cpu = t_core.get_machine("summit").tiers["cpu_net:off-node"].model
    same(r_core.crossover_size(r_gpu, r_cpu), t_core.crossover_size(t_gpu, t_cpu))

    cfg = tcfgs.get_config(arch)
    for pods in (1, 2):
        rt, tt = r_core.TpuPodTopology(pods=pods), t_core.TpuPodTopology(pods=pods)
        for mb in (1, 64):
            same(r_core.plan_tpu_allreduce(rt, mb * 2.0**20), t_core.plan_tpu_allreduce(tt, mb * 2.0**20))
            same(r_core.plan_tpu_crosspod(rt, mb * 2.0**20, 4), t_core.plan_tpu_crosspod(tt, mb * 2.0**20, 4))
        kw = dict(tokens_per_chip=4096, d_model=cfg.d_model, n_experts=cfg.n_experts,
                  top_k=cfg.top_k, crosses_pod=pods > 1)
        r_plan, t_plan = r_core.plan_moe_alltoall(rt, **kw), t_core.plan_moe_alltoall(tt, **kw)
        same(r_plan, t_plan)
        assert t_plan.predicted_time > 0
        same(r_core.planner.plan_ep_dispatch(rt, 65536.0, (4, 4)),
             t_core.planner.plan_ep_dispatch(tt, 65536.0, (4, 4)))


@pytest.mark.parametrize("name", BUILTIN)
def test_event_engine_on_every_candidate(name):
    """``run_schedule`` (and its reference engine) and ``bottleneck_report``
    over every schedule ``candidate_schedules`` builds."""
    for s, n, split in ((4096.0, 4, False), (float(1 << 20), 32, True)):
        r_cands = r_core.schedule.candidate_schedules(name, s, n, split_messages=split)
        t_cands = t_core.schedule.candidate_schedules(name, s, n, split_messages=split)
        same(r_cands, t_cands)
        for key in r_cands:
            r_res = r_core.events.run_schedule(r_cands[key])
            t_res = t_core.events.run_schedule(t_cands[key])
            same(r_res, t_res, where=key)
            same(r_res.critical_path(), t_res.critical_path(), where=key)
            same(r_core.events.run_schedule_reference(r_cands[key]),
                 t_core.events.run_schedule_reference(t_cands[key]), where=key)
            r_rep = r_core.events.bottleneck_report(r_res)
            t_rep = t_core.events.bottleneck_report(t_res)
            same(r_rep, t_rep, where=key)
            assert r_rep.summary() == t_rep.summary()


def test_fitting_on_seeded_samples():
    rng = np.random.default_rng(21)
    sizes = np.unique(np.logspace(0, 8, 48).astype(np.int64)).astype(np.float64)
    # three protocol segments, multiplicative noise
    truth = np.where(sizes <= 4096, 1e-6 + 2e-10 * sizes,
                     np.where(sizes <= 65536, 3e-6 + 1e-10 * sizes, 9e-6 + 8e-11 * sizes))
    noisy = truth * (1.0 + 0.03 * rng.standard_normal(sizes.size))
    r_f, t_f = r_core.fitting, t_core.fitting
    same(r_f.fit_postal(sizes, noisy), t_f.fit_postal(sizes, noisy))
    same(r_f.detect_breakpoints(sizes, noisy), t_f.detect_breakpoints(sizes, noisy))
    same(r_f.detect_breakpoints(sizes, noisy, n_break=1),
         t_f.detect_breakpoints(sizes, noisy, n_break=1))
    for thr in ("detect", (4096, 65536), None):
        r_m = r_f.fit_transport_model(sizes, noisy, thresholds=thr)
        t_m = t_f.fit_transport_model(sizes, noisy, thresholds=thr)
        same(r_m, t_m)
        same(r_m.time(sizes), t_m.time(sizes))
    ppn = np.arange(1, 9)
    t_ppn = 2e-6 + np.maximum(1e-10, ppn * 3e-11) * 65536 * (1 + 0.01 * rng.random(8))
    same(r_f.fit_maxrate_beta_N(ppn, t_ppn, 65536.0, 1e-10, 2e-6),
         t_f.fit_maxrate_beta_N(ppn, t_ppn, 65536.0, 1e-10, 2e-6))
    r_model = r_core.get_machine("lassen").tiers["gpu_net:off-node"].model
    t_model = t_core.get_machine("lassen").tiers["gpu_net:off-node"].model
    same(r_f.round_trip_check(r_model, noise=0.02, seed=3),
         t_f.round_trip_check(t_model, noise=0.02, seed=3))


def _staged_samples(core):
    """Summit's own tables as measurements: direct, staged and copy tiers,
    and locality-split direct pairs."""
    sizes = np.unique(np.logspace(0, 8, 40).astype(np.int64)).astype(np.float64)
    spec = core.get_machine("summit")

    def synth(tier):
        return sizes, np.asarray(spec.tiers[tier].time(sizes), np.float64)

    pairs = {loc: synth(f"gpu_net:{loc}") for loc in ("on-socket", "on-node", "off-node")}
    return dict(direct_net=synth("gpu_net:off-node"), staged_net=synth("cpu_net:off-node"),
                copy_d2h=synth("copy_d2h:on-socket"), copy_h2d=synth("copy_h2d:on-socket"),
                placed_pairs=pairs, direct_beta_N=spec.tiers["gpu_net:off-node"].beta_N,
                staged_beta_N=float("nan"), injectors_per_node=6, lanes_per_injector=6,
                thresholds="detect")


def test_spec_from_measurements_staged_family():
    specs = []
    for core in (r_core, t_core):
        kw = _staged_samples(core)
        specs.append(core.benchmark.spec_from_measurements(
            "fitted_parity", kw.pop("direct_net"), register=False, **kw))
    r_spec, t_spec = specs
    same(r_spec, t_spec)
    assert r_spec.fingerprint == t_spec.fingerprint
    assert "fitted_parity" not in t_core.registered_machines()
    for s, n in ((1024.0, 1), (1024.0, 64), (float(1 << 20), 8)):
        same(r_core.plan_messages(r_spec, s, n), t_core.plan_messages(t_spec, s, n))
    same(r_drift.summary(), t_drift.summary())
    same(r_drift.records(), t_drift.records())
    same(r_drift.worst(3), t_drift.worst(3))
    assert r_drift.n_evicted() == t_drift.n_evicted() == 0


def test_spec_from_measurements_registers_direct_only():
    sizes = [float(1 << p) for p in range(10, 24, 2)]
    direct = (sizes, [3e-6 + 4e-11 * s for s in sizes])
    r_spec = r_core.benchmark.spec_from_measurements("fitted_parity_reg", direct)
    t_spec = t_core.benchmark.spec_from_measurements("fitted_parity_reg", direct)
    same(r_spec, t_spec)
    assert t_core.get_machine("fitted_parity_reg") is t_spec
    r_plan = r_core.plan_messages("fitted_parity_reg", 65536.0, 4)
    t_plan = t_core.plan_messages("fitted_parity_reg", 65536.0, 4)
    same(r_plan, t_plan)
    assert t_plan.strategy == "gpudirect" and t_plan.predicted_time > 0
    same(r_drift.summary(tol=0.01), t_drift.summary(tol=0.01))


@pytest.mark.parametrize("name", BUILTIN)
def test_shrink_and_validate_spec(name):
    r_spec, t_spec = r_core.get_machine(name), t_core.get_machine(name)
    r_core.machine.validate_spec(r_spec)
    t_core.machine.validate_spec(t_spec)
    for lost, total in ((1, None), ([0], None), (2, 12)):
        same(r_core.machine.shrink_spec(r_spec, lost, total_ranks=total),
             t_core.machine.shrink_spec(t_spec, lost, total_ranks=total))
    tier = next(iter(t_spec.tiers))
    for bad in (float("nan"), -1e-6):
        broken = {}
        for core, spec in ((r_core, r_spec), (t_core, t_spec)):
            model = core.postal.SimplePostalModel(core.PostalParams(bad, 1e-10))
            tiers = dict(spec.tiers)
            tiers[tier] = core.machine.TransportTier(tier, model)
            with pytest.raises(ValueError) as err:
                core.machine.validate_spec(core.MachineSpec(name, tiers, spec.paths))
            broken[core] = str(err.value)
        assert broken[r_core] == broken[t_core]


def test_bench_host_device_roundtrip_on_cpu():
    res = t_core.benchmark.bench_host_device_roundtrip(sizes=(1 << 10, 1 << 16, 1 << 22),
                                                       device="cpu")
    assert res.sizes == [1 << 10, 1 << 16, 1 << 22]
    assert all(math.isfinite(t) and t > 0 for t in res.times)
    # each call copies (``.to("cpu")`` alone would return the same tensor):
    # 4 MiB costs far more than 1 KiB
    assert res.times[-1] > 10 * res.times[0]
    assert math.isfinite(res.fitted.alpha) and res.fitted.alpha >= 0
    assert math.isfinite(res.fitted.beta) and res.fitted.beta >= 0
    assert len(res.csv_rows("h2d")) == 4
    spec = t_core.benchmark.spec_from_measurements("cpu_copy", res, register=False)
    assert t_core.plan_messages(spec, 65536.0, 4).strategy == "gpudirect"


def test_bench_host_device_roundtrip_default_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_core.benchmark.bench_host_device_roundtrip()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_core.benchmark.bench_host_device_roundtrip(device="cuda:0")

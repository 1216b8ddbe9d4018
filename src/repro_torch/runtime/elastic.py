"""Elastic re-scale: move a run between meshes of different shape.

Ported from ``repro.runtime.elastic``.  A checkpoint stores leaves whole
(``checkpoint.checkpointer``), so elasticity is re-placement: build
shardings for the NEW mesh from the same rules (``sharding.specs``) and keep
each rank's block.  In the port a mesh is a world of processes, one a rank:
:func:`reshard_tree` cuts this rank's block out of each whole leaf (the
reference's ``device_put``), and :func:`restore_on_mesh` reads a checkpoint
leaf by leaf into this rank's blocks on a new mesh, with no collective.
Batch-size bookkeeping: keep the GLOBAL batch constant across re-scales
(the per-rank batch changes), so the loss trajectory is unchanged.

The *planning* half of elasticity lives here too: a host drop is not just
a re-placement but a re-decision.  :func:`shrink_and_replan` derives the
surviving-mesh spec (:func:`repro_torch.core.machine.shrink_spec`) and
routes it through :func:`repro_torch.obs.health.request_replan`:
re-registration under the old name bumps the registry generation and the
shrunk fingerprint misses every cached plan, so the very next ``select_*``
call plans for the world that actually survives.  :func:`host_drop_drill`
runs the whole contract end to end (drop -> restore -> shrink -> re-plan ->
finish with loss continuity) deterministically, and returns the
reference's evidence dict, key for key.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.models.convert import tree_leaves, tree_unflatten
from repro_torch.sharding import specs


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """This rank's block of each whole leaf of ``tree`` by the matching
    ``Sharding`` of ``shardings`` (by the rank's place on its mesh), a new
    tensor on the leaf's device."""
    leaves = tree_leaves(tree)
    sh = tree_leaves(shardings)
    if len(sh) != len(leaves):
        raise ValueError(f"reshard_tree: {len(sh)} shardings for {len(leaves)} leaves")
    return tree_unflatten(tree, [s.shard(leaf) for leaf, s in zip(leaves, sh)])


def restore_on_mesh(
    ckpt: Checkpointer,
    step: int,
    like: Any,  # tree of tensors (meta ones will do) of the params' shapes
    new_mesh,
    *,
    fsdp: bool = True,
    device=None,
    coord: Optional[Mapping[str, int]] = None,
) -> Any:
    """Load checkpointed params onto a different mesh (grow or shrink):
    this rank's blocks by ``param_shardings(like, new_mesh)``, read one
    leaf at a time, no collective.  The tree keeps the checkpoint's shapes
    (no ``tp_adapt``).  ``device`` places the leaves of a ``like`` on the
    meta device; ``coord`` (axis -> index) stands for this rank's place on
    a mesh given as axis sizes."""
    shardings = specs.param_shardings(like, new_mesh, fsdp=fsdp)
    return ckpt.restore(step, like, shardings=shardings, device=device, coord=coord)


# --------------------------------------------------------------------------
# Mesh reshape as a planning event.
# --------------------------------------------------------------------------

def shrink_and_replan(
    machine: str,
    lost_hosts: Union[int, Iterable[int]],
    *,
    spec=None,
    total_ranks: Optional[int] = None,
):
    """Shrink the registered spec around lost hosts and trigger a re-plan.

    Resolves ``machine`` (or uses ``spec``), derives the surviving-mesh
    spec via :func:`repro_torch.core.machine.shrink_spec`, and re-registers
    it through :func:`repro_torch.obs.health.request_replan` with
    ``reason="host_drop"``: generation bump + fingerprint change means no
    cached plan computed against the dead world can ever be served again.
    Counts ``runtime.elastic.reshapes`` (plus health's ``health.replans`` /
    ``health.replan.host_drop``).  Returns the shrunk spec.
    """
    from repro_torch.core.machine import resolve_spec, shrink_spec
    from repro_torch.obs import health as obs_health
    from repro_torch.obs import metrics as obs_metrics

    base = spec if spec is not None else resolve_spec(machine)
    shrunk = shrink_spec(base, lost_hosts, total_ranks=total_ranks)
    obs_health.request_replan(machine, reason="host_drop", spec=shrunk)
    if obs_metrics._ENABLED:
        obs_metrics.inc("runtime.elastic.reshapes")
    return shrunk


# --------------------------------------------------------------------------
# The elasticity drill: the whole loss->reshape->re-plan contract, end to
# end and deterministic.
# --------------------------------------------------------------------------

def _toy_batch(step: int, seed: int) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed * 100_003 + step)
    return {"x": torch.from_numpy(rng.standard_normal(8)),
            "y": torch.from_numpy(rng.standard_normal(8))}


def _mean(t: torch.Tensor) -> float:
    # numpy's pairwise order, as the reference's np.mean adds: torch adds
    # the 8 values in another order, which rounds otherwise
    return float(np.mean(t.numpy()))


def _toy_step(params, opt, batch):
    # deterministic scalar regression: SGD with momentum, all float64
    w, b = params["w"], params["b"]
    pred = batch["x"] * w + b
    err = pred - batch["y"]
    loss = _mean(err * err)
    gw = _mean(2.0 * err * batch["x"])
    gb = _mean(2.0 * err)
    mw = 0.9 * opt["mw"] + gw
    mb = 0.9 * opt["mb"] + gb
    new_params = {"w": w - 0.05 * mw, "b": b - 0.05 * mb}
    new_opt = {"mw": mw, "mb": mb}
    return new_params, new_opt, {"loss": loss}


def _toy_init() -> tuple:
    zero = lambda: torch.zeros((), dtype=torch.float64)  # noqa: E731
    return {"w": zero(), "b": zero()}, {"mw": zero(), "mb": zero()}


def host_drop_drill(
    *,
    base_machine: str = "summit",
    machine: str = "elastic_drill",
    total_ranks: int = 12,
    drop_hosts: Iterable[int] = (8, 9, 10, 11),
    drop_at: int = 6,
    nbytes: float = 8192.0,
    n_msgs: int = 8,
    total_steps: int = 12,
    checkpoint_every: int = 4,
    seed: int = 0,
    workdir: Optional[str] = None,
) -> dict:
    """Injected host loss, end to end.  Returns the full evidence dict.

    1. register ``base_machine``'s spec under the scratch name ``machine``
       with fact ``n_gpus = total_ranks`` (a multi-node job) and take the
       planner's schedule pick: the *stale* plan for the full mesh;
    2. run a deterministic toy training under ``run_with_recovery`` with a
       seeded :class:`~repro_torch.runtime.scenarios.Scenario` dropping
       ``drop_hosts`` at step ``drop_at``: each :class:`HostLost` restores
       the latest checkpoint AND routes :func:`shrink_and_replan`;
    3. the planner's pick on the shrunk mesh is the *fresh* plan; both are
       judged under the event engine on the shrunk spec at the surviving
       peer count: fresh must beat (or tie) stale;
    4. the faulted run's final state is compared bitwise against an
       uninterrupted clean run: loss continuity across the reshape.

    Deterministic: same seed -> same scenario -> same evidence dict, the
    reference's to the float.
    """
    import dataclasses
    import tempfile

    from repro_torch.comms import autotune
    from repro_torch.core.machine import get_machine, register_machine, registry_generation
    from repro_torch.core.schedule import search_schedules
    from repro_torch.runtime.fault import BackoffPolicy, run_with_recovery
    from repro_torch.runtime.scenarios import HOST_DROP, Scenario, ScenarioEvent, ScenarioInjector

    drop_hosts = tuple(int(h) for h in drop_hosts)
    base = get_machine(base_machine)
    spec0 = dataclasses.replace(
        base,
        name=machine,
        facts={**base.facts, "n_gpus": total_ranks,
               "ppn": int(base.facts.get("injectors_per_node", 1))},
        derived_from=base_machine,
    )
    register_machine(machine, spec0)
    fp_before = spec0.fingerprint
    gen_before = registry_generation()

    stale_pick = autotune.select_schedule(machine, nbytes, n_msgs)
    cache_before = autotune.plan_cache_info()

    scenario = Scenario(
        [ScenarioEvent(at=drop_at, kind=HOST_DROP, host=h) for h in drop_hosts],
        seed=seed, name="host_drop_drill",
    )
    injector = ScenarioInjector(scenario)

    # clean reference run: same seeds, no faults, its own checkpoint dir
    with tempfile.TemporaryDirectory(prefix="elastic_clean_") as d:
        p0, o0 = _toy_init()
        clean = run_with_recovery(
            step_fn=_toy_step, batch_fn=lambda s: _toy_batch(s, seed),
            init_params=p0, init_opt=o0,
            checkpointer=Checkpointer(d), total_steps=total_steps,
            checkpoint_every=checkpoint_every,
        )

    reshapes = []

    def on_drop(e, step):
        shrunk = shrink_and_replan(machine, [e.host])
        reshapes.append({"step": step, "host": e.host,
                         "n_gpus": int(shrunk.facts["n_gpus"]),
                         "fingerprint": shrunk.fingerprint})

    backoff = BackoffPolicy(base=0.01, max_delay=0.05, seed=seed)
    delays = []

    if workdir is None:
        ctx = tempfile.TemporaryDirectory(prefix="elastic_drill_")
        workdir_path = ctx.name
    else:
        ctx = None
        workdir_path = workdir
    try:
        p0, o0 = _toy_init()
        faulted = run_with_recovery(
            step_fn=_toy_step, batch_fn=lambda s: _toy_batch(s, seed),
            init_params=p0, init_opt=o0,
            checkpointer=Checkpointer(workdir_path),
            total_steps=total_steps, checkpoint_every=checkpoint_every,
            fault_hook=injector.fault_hook,
            on_host_drop=on_drop,
            max_restarts=len(drop_hosts) + 2,
            backoff=backoff, sleep_fn=delays.append,
        )
    finally:
        if ctx is not None:
            ctx.cleanup()

    shrunk = get_machine(machine)
    fp_after = shrunk.fingerprint
    survivors = int(shrunk.facts["n_gpus"])
    fresh_pick = autotune.select_schedule(machine, nbytes, n_msgs)
    cache_after = autotune.plan_cache_info()

    # judge both picks on the world that actually exists now
    judged = search_schedules(shrunk, nbytes, n_msgs, peers=survivors)
    t_stale = float(judged[stale_pick].makespan)
    t_fresh = float(judged[fresh_pick].makespan)

    # the DES-side view of the same scenario: the stale plan's pessimistic
    # capacity squeeze at the dead ranks
    overrides = scenario.capacity_overrides(spec0, drop_at)

    continuity = (
        faulted.step == clean.step
        and all(float(faulted.params[k]) == float(clean.params[k]) for k in clean.params)
        and all(float(faulted.opt_state[k]) == float(clean.opt_state[k])
                for k in clean.opt_state)
    )
    return {
        "machine": machine,
        "base_machine": base_machine,
        "scenario": scenario.to_json(),
        "total_ranks": total_ranks,
        "survivors": survivors,
        "reshapes": reshapes,
        "backoff_delays": [float(d) for d in delays],
        "fingerprint_before": fp_before,
        "fingerprint_after": fp_after,
        "fingerprint_changed": fp_after != fp_before,
        "generations_bumped": registry_generation() - gen_before,
        "plan_cache_misses": (cache_after["misses"] - cache_before["misses"]),
        "stale_pick": stale_pick,
        "fresh_pick": fresh_pick,
        "pick_changed": fresh_pick != stale_pick,
        "t_stale_on_shrunk": t_stale,
        "t_fresh_on_shrunk": t_fresh,
        "replanned_beats_stale": t_fresh <= t_stale,
        "speedup": (t_stale / t_fresh) if t_fresh > 0 else float("inf"),
        "des_overrides": len(overrides),
        "completed_steps": int(faulted.step),
        "survived": faulted.step == total_steps,
        "loss_continuity": bool(continuity),
    }

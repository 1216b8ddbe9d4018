"""The port's training entry point and checkpointer, on the CPU.

A checkpoint written by the JAX package restores in the port bit for bit
and the other way round (bf16 weights as uint16, f32 moments, the int32
step, the same leaf names); the training loss falls and a resumed run
equals the full run bit for bit (mirrors of ``test_integration.py``'s
training tests); ``run`` started from weights carried over from JAX
follows the reference's ``launch.train.main``; ``--mesh-shape`` over more than one device
is refused.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.optim as jopt
import repro_torch.configs as tcfgs
import repro_torch.optim as topt
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.launch import train as jtrain
from repro.runtime.straggler import EwmaZScore as JEwmaZScore
from repro.runtime.straggler import StragglerMonitor as JStragglerMonitor
from repro.models import init_params as jinit_params
from repro_torch.checkpoint import Checkpointer as TCheckpointer
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import opt_state_from_jax, params_from_jax, tree_leaves
from repro_torch.models.transformer import init_params as tinit_params
from repro_torch.runtime import EwmaZScore as TEwmaZScore
from repro_torch.runtime import StragglerMonitor as TStragglerMonitor

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b"  # bf16 smoke weights with f32 XATTN gates and nested groups


def _jax_blob(seed: int):
    """{"params": bf16 smoke weights, "opt": an AdamW state with step 3 and
    random moments} of the JAX package."""
    cfg = jcfgs.smoke_config(ARCH)
    params = jax.jit(jinit_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    draw = lambda p: jnp.asarray(rng.standard_normal(p.shape, dtype=np.float32))  # noqa: E731
    opt = jopt.AdamWState(step=jnp.int32(3), mu=jax.tree.map(draw, params),
                          nu=jax.tree.map(lambda p: jnp.abs(draw(p)), params))
    return {"params": params, "opt": opt}


def _port_like():
    params = tinit_params(tcfgs.smoke_config(ARCH), torch.Generator().manual_seed(9))
    return {"params": params, "opt": topt.init_state(params)}


def _bits(a) -> np.ndarray:
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else np.asarray(a)
    return a.view(np.uint16) if a.dtype.name in ("bfloat16", "int16") else a


def _assert_bitwise(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl) > 0
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[1] == j.dtype.name
        assert np.array_equal(_bits(t), _bits(j))


def test_checkpoint_from_reference_restores_in_port(tmp_path):
    blob = _jax_blob(0)
    JCheckpointer(str(tmp_path)).save(7, blob)
    ck = TCheckpointer(str(tmp_path))
    assert ck.latest_step() == 7
    got = ck.restore(7, _port_like())
    assert isinstance(got["opt"], topt.AdamWState) and got["opt"].step.dtype == torch.int32
    _assert_bitwise(blob, got)
    want = {"params": params_from_jax(jax.tree.map(np.asarray, blob["params"])),
            "opt": opt_state_from_jax(jax.tree.map(np.asarray, blob["opt"]))}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def test_checkpoint_from_port_restores_in_reference(tmp_path):
    """The port writes its own tree (bf16 weights, a trained-looking state);
    the reference restores it into its structure bit for bit, and both
    packages name the leaves alike in meta.json."""
    like = _port_like()
    rng = np.random.default_rng(1)
    for t in tree_leaves(like["opt"].mu) + tree_leaves(like["opt"].nu):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, dtype=np.float32)))
    blob = {"params": like["params"], "opt": like["opt"]._replace(step=torch.tensor(
        5, dtype=torch.int32))}
    ck = TCheckpointer(str(tmp_path / "port"))
    ck.save(5, blob, block=False)
    ck.wait()
    jck = JCheckpointer(str(tmp_path / "port"))
    assert jck.latest_step() == 5
    got = jck.restore(5, _jax_blob(0))
    _assert_bitwise(got, blob)
    JCheckpointer(str(tmp_path / "jax")).save(5, got)
    metas = [json.load(open(os.path.join(tmp_path, d, "step_00000005", "meta.json")))
             for d in ("port", "jax")]
    assert metas[0] == metas[1]
    assert "opt/step" in metas[0]["names"] and "params/embed/tok" in metas[0]["names"]
    assert dict(zip(metas[0]["names"], metas[0]["dtypes"]))["params/embed/tok"] == "bfloat16"


def test_checkpointer_async_gc_and_interrupted_writes(tmp_path):
    ck = TCheckpointer(str(tmp_path), keep=2)
    like = {"w": torch.arange(6, dtype=torch.float32), "b": torch.ones(2, dtype=torch.bfloat16)}
    for step in (1, 2, 3):
        ck.save(step, {k: v * step for k, v in like.items()}, block=False)
    ck.wait()
    os.makedirs(tmp_path / "step_00000009")  # a write cut before its commit marker
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    got = ck.restore(3, like)
    assert torch.equal(got["w"], like["w"] * 3) and torch.equal(got["b"], like["b"] * 3)


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """An async save holds the values at the call, though the tensors are
    updated in place (as ``train_step`` does) before the file is written."""
    import threading

    from repro_torch.checkpoint import checkpointer

    written = threading.Event()
    release = threading.Event()
    savez = checkpointer.np.savez

    def held_savez(*args, **kwargs):
        assert release.wait(timeout=60)
        savez(*args, **kwargs)
        written.set()

    monkeypatch.setattr(checkpointer.np, "savez", held_savez)
    tree = {"w": torch.arange(4, dtype=torch.float32), "b": torch.ones(3, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in tree.items()}
    ck = TCheckpointer(str(tmp_path))
    ck.save(1, tree, block=False)
    for t in tree.values():
        t.add_(5)
    release.set()
    ck.wait()
    assert written.is_set()
    got = ck.restore(1, tree)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("kw", [{}, {"alpha": 0.3, "z_threshold": 2.0,
                                      "consecutive_for_action": 2, "warmup_steps": 2}])
def test_straggler_monitor_matches_reference(kw):
    """The same step walls into both packages' monitors: a constant start
    (no variance yet), noise, single hiccups and runs of slow steps; after
    each, the same event (step, wall, EWMA, z), EWMA, streak and advice, and
    the same list of events at the end."""
    rng = np.random.default_rng(0)
    walls = np.concatenate([np.full(6, 0.5), 0.5 + 0.01 * rng.standard_normal(60)])
    walls[[10, 25]] += 0.2
    walls[40:44] += 0.3
    walls[50:52] += 0.3
    jmon, tmon = JStragglerMonitor(**kw), TStragglerMonitor(**kw)
    advised = 0
    for step, w in enumerate(walls.tolist()):
        jev, tev = jmon.record(step, w), tmon.record(step, w)
        assert (tev is None) == (jev is None), step
        if jev is not None:
            assert dataclasses.asdict(tev) == dataclasses.asdict(jev), step
        assert (tmon.ewma, tmon.consecutive_slow) == (jmon.ewma, jmon.consecutive_slow), step
        assert tmon.should_mitigate == jmon.should_mitigate, step
        advised += tmon.should_mitigate
    assert len(jmon.events) >= 4 and advised > 0
    assert [dataclasses.asdict(e) for e in tmon.events] == \
        [dataclasses.asdict(e) for e in jmon.events]


@pytest.mark.parametrize("kw", [{}, dict(alpha=0.3, z_threshold=2.0, warmup=2)])
def test_ewma_zscore_matches_reference(kw):
    """One series into both packages' ``EwmaZScore.update``: the same z,
    ``ewma``, ``ewvar`` and ``consecutive`` after each sample, and the same
    verdicts through ``is_anomalous``/``note_*`` (the link-health monitor's
    way of driving it)."""
    rng = np.random.default_rng(1)
    series = np.concatenate([np.full(4, 2.0), 2.0 + 0.05 * rng.standard_normal(40)])
    series[[12, 30, 31, 32]] += 1.0
    jdet, tdet = JEwmaZScore(**kw), TEwmaZScore(**kw)
    flagged = 0
    for i, v in enumerate(series.tolist()):
        assert tdet.zscore(v) == jdet.zscore(v) and tdet.is_anomalous(v) == jdet.is_anomalous(v)
        assert tdet.update(v) == jdet.update(v), i
        assert (tdet.ewma, tdet.ewvar, tdet.n, tdet.consecutive) == \
            (jdet.ewma, jdet.ewvar, jdet.n, jdet.consecutive), i
        flagged += tdet.consecutive > 0
    assert flagged >= 3
    for det in (jdet, tdet):
        det.note_anomaly()
        det.note_normal(2.0)
    assert dataclasses.asdict(tdet) == dataclasses.asdict(jdet)


def test_train_loss_decreases():
    loss = ttrain.main([
        "--arch", "olmo-1b", "--smoke", "--steps", "8", "--batch", "4",
        "--seq", "32", "--warmup", "2", "--lr", "3e-3", "--log-every", "4",
        "--device", "cpu",
    ])
    assert loss < 6.5  # started ~ ln(512)=6.2+; must have moved down


def test_train_resume_identical(tmp_path):
    args = ["--arch", "olmo-1b", "--smoke", "--batch", "2", "--seq", "32", "--warmup", "1",
            "--lr", "1e-3", "--checkpoint-every", "3", "--device", "cpu"]
    full = ttrain.main(args + ["--steps", "6", "--checkpoint-dir", str(tmp_path / "a")])
    ckdir = str(tmp_path / "b")
    ttrain.main(args + ["--steps", "3", "--total-steps", "6", "--checkpoint-dir", ckdir])
    resumed = ttrain.main(args + ["--steps", "6", "--checkpoint-dir", ckdir])
    assert resumed == full  # bit for bit


def test_run_from_reference_weights_follows_reference_main():
    """The reference's ``launch.train.main`` on smoke llama (bf16, weights from PRNGKey(0))
    and the port's ``run`` on those weights carried across: the same last
    loss within bf16 rounding (5e-2), falling; ``run`` returns a wall time
    for each step and leaves the given state at the step count it reached."""
    args = ["--arch", "llama3.2-1b", "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
            "--warmup", "1", "--lr", "3e-3", "--log-every", "100"]
    want = jtrain.main(args)
    cfg = tcfgs.smoke_config("llama3.2-1b")
    jp = jax.jit(jinit_params, static_argnums=0)(jcfgs.smoke_config("llama3.2-1b"),
                                                 jax.random.PRNGKey(0))
    run_cfg = TRunConfig(model=cfg, seq_len=32, global_batch=4, n_microbatches=1,
                         learning_rate=3e-3, warmup_steps=1, total_steps=4)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    opt = topt.init_state(params)
    losses, walls = ttrain.run(cfg, run_cfg, seed=0, steps=4, device="cpu", params=params,
                               opt_state=opt)
    assert len(losses) == len(walls) == 4 and losses[-1] < losses[0]
    assert all(w > 0 for w in walls)
    assert int(opt.step) == 4  # the given state is updated in place, its step count too
    assert abs(losses[-1] - want) <= 5e-2


def test_mesh_shape_over_devices_refused(capsys):
    """A mesh of more than three axes is refused; one of more than one
    device trains across that many ranks (here two data-parallel ranks on
    the CPU, the one-device run's loss), one device trains in-process."""
    with pytest.raises(ValueError, match="one to three positive sizes"):
        ttrain.main(["--smoke", "--device", "cpu", "--steps", "1", "--mesh-shape", "1,1,2,1"])
    args = ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16"]
    loss = ttrain.main(args + ["--mesh-shape", "1,1"])
    assert np.isfinite(loss)
    assert abs(ttrain.main(args + ["--mesh-shape", "2,1"]) - loss) < 2e-2

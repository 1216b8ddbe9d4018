"""Elastic re-scale across gloo worlds on the CPU, held against the
reference's single-device continuation (``tests/_multidevice_checks.py``'s
``elastic_reshard``, ``elastic_shrink_continuity`` and
``elastic_grow_continuity``).

Smoke llama on the reference's weights (``init_params`` from
``PRNGKey(0)``) and batches (``randint`` from ``PRNGKey(1)``, ``(2)`` and
``(3)``, 8 x 32).  A world of 8 on (2, 4) trains step 1 and saves the
``{"params", "opt"}`` blob; on (4, 2) the same world restores it, each
rank's blocks exactly the saved tree's.  A world of 4 on (2, 2) restores
it (shrink), trains step 2 and saves; a world of 8 on (2, 4) restores that
(grow) and trains step 3.  Each step's loss and every rank's final blocks
of the parameters and AdamW moments hold the reference's single-device
``train_step`` continuation: in f32 at 1e-4 of each leaf's largest
magnitude, in bf16 at the reference's own 2e-2 (loss) and 0.15
(parameters).  The reference package's checkpoint restores with
shardings; ``launch.train.main`` resumes a (2, 2) checkpoint on (4, 1),
and a world's resume runs no collective but one barrier.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import RunConfig as JRunConfig
from repro.models import init_params as jinit_params
from repro.models.steps import train_step as jtrain_step
from repro.optim import init_state as jinit_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import run_world
from repro_torch.models.convert import params_from_jax, tree_leaves, tree_map2
from repro_torch.models.transformer import param_shapes
from repro_torch.optim import init_state
from repro_torch.runtime import checks, restore_on_mesh
from repro_torch.sharding import checks as shard_checks
from repro_torch.sharding.specs import opt_shardings, param_shardings

torch.set_num_threads(1)

WORLD_TIMEOUT = 300.0
CASES = {"f32": "float32", "bf16": "bfloat16"}
BIG, SMALL, SWAPPED = (2, 4), (2, 2), (4, 2)
TOL = 1e-4
BF16_LOSS, BF16_PARAMS = 2e-2, 0.15  # tests/_multidevice_checks.py:225, 236, 243


def _coord(dims, rank: int) -> dict:
    return {"data": rank // dims[1], "model": rank % dims[1]}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_config(case):
    return dataclasses.replace(jcfgs.smoke_config(shard_checks.TRAIN_ARCH), dtype=CASES[case])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's continuation per case, the three worlds' results,
    the checkpoint directories)."""
    vocab = jcfgs.smoke_config(shard_checks.TRAIN_ARCH).vocab_size
    tokens = [torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(k), (8, shard_checks.TRAIN_SEQ), 0, vocab), np.int32))
        for k in (1, 2, 3)]
    ref, weights = {}, {}
    for case in CASES:
        jc = _jax_config(case)
        t_run = shard_checks.train_run(case)
        jr = JRunConfig(model=jc, **{f.name: getattr(t_run, f.name)
                                     for f in dataclasses.fields(t_run) if f.name != "model"})
        jp = jinit_params(jc, jax.random.PRNGKey(0))
        weights[case] = params_from_jax(jax.tree.map(np.asarray, jp))
        jo = jinit_state(jp)
        step = jax.jit(lambda p, o, b, jc=jc, jr=jr: jtrain_step(jc, jr, p, o, b))
        losses = []
        for toks in tokens:
            jp, jo, m = step(jp, jo, {"tokens": jnp.asarray(toks.numpy())})
            losses.append(float(m["loss"]))
        f32 = lambda t: params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), t))  # noqa: E731
        ref[case] = {"losses": losses, "params": f32(jp), "mu": f32(jo.mu), "nu": f32(jo.nu)}
    dirs = {case: str(tmp_path_factory.mktemp(f"elastic_{case}")) for case in CASES}

    def legs(case, **kw):
        return dict(cfg=shard_checks.train_config(case), run=shard_checks.train_run(case), **kw)

    first = run_world(checks.leg_program, 8,
                      [leg for case in CASES for leg in (
                          legs(case, mesh=BIG, params=weights[case], tokens=tokens[:1],
                               save=(dirs[case], 1)),
                          legs(case, mesh=SWAPPED, restore=(dirs[case], 1), blocks=True))],
                      device="cpu", timeout=WORLD_TIMEOUT)
    shrunk = run_world(checks.leg_program, 4,
                       [legs(case, mesh=SMALL, restore=(dirs[case], 1), check=True,
                             tokens=tokens[1:2], save=(dirs[case], 2)) for case in CASES],
                       device="cpu", timeout=WORLD_TIMEOUT)
    grown = run_world(checks.leg_program, 8,
                      [legs(case, mesh=BIG, restore=(dirs[case], 2), tokens=tokens[2:],
                            blocks=True) for case in CASES],
                      device="cpu", timeout=WORLD_TIMEOUT)
    worlds = {case: {"first": [r[2 * i] for r in first], "swapped": [r[2 * i + 1] for r in first],
                     "shrunk": [r[i] for r in shrunk], "grown": [r[i] for r in grown]}
              for i, case in enumerate(CASES)}
    return ref, worlds, dirs


def _blocks(case, tree, dims, rank):
    sh = param_shardings(param_shapes(shard_checks.train_config(case)), dict(zip(
        ("data", "model"), dims)))
    return tree_map2(lambda s, t: s.shard(t, coord=_coord(dims, rank)), sh, tree)


@pytest.mark.parametrize("case", list(CASES))
def test_restore_on_another_mesh_is_exact(runs, case):
    """(2, 4)'s checkpoint restored on (4, 2): every rank's blocks of the
    parameters and moments are the saved tree's, bit for bit."""
    _, worlds, dirs = runs
    cfg = shard_checks.train_config(case)
    shapes = param_shapes(cfg)
    saved = Checkpointer(dirs[case]).restore(1, {"params": shapes, "opt": init_state(shapes)},
                                             device="cpu")
    for r, got in enumerate(worlds[case]["swapped"]):
        assert got["blocks"]["step"] == 1 and "metrics" in got and not got["metrics"]
        for name, tree in (("params", saved["params"]), ("mu", saved["opt"].mu),
                           ("nu", saved["opt"].nu)):
            want = tree_leaves(_blocks(case, tree, SWAPPED, r))
            have = tree_leaves(got["blocks"][name])
            assert len(want) == len(have) > 0
            for w, h in zip(want, have):
                assert np.array_equal(h, w.float().numpy()), (r, name, tuple(w.shape))
    for r, got in enumerate(worlds[case]["shrunk"]):  # the shrunk world's own check
        assert got["leaves_checked"] == 3 * len(tree_leaves(shapes)) + 1  # params, mu, nu, step


@pytest.mark.parametrize("case", list(CASES))
def test_shrink_then_grow_holds_the_single_device_continuation(runs, case):
    ref, worlds, _ = runs
    losses = [w[0]["metrics"][0]["loss"] for w in (worlds[case]["first"], worlds[case]["shrunk"],
                                                   worlds[case]["grown"])]
    for stage in ("first", "shrunk", "grown"):  # every rank reads the same metrics
        assert len({w["metrics"][0]["loss"] for w in worlds[case][stage]}) == 1
    for got, want in zip(losses, ref[case]["losses"]):
        if case == "f32":
            assert abs(got - want) <= TOL * max(abs(want), 1.0), (losses, ref[case]["losses"])
        else:
            assert abs(got - want) < BF16_LOSS, (losses, ref[case]["losses"])
    for r, got in enumerate(worlds[case]["grown"]):
        assert got["blocks"]["step"] == 3
        names = ("params", "mu", "nu") if case == "f32" else ("params",)
        for name in names:
            want = tree_leaves(_blocks(case, ref[case][name], BIG, r))
            have = tree_leaves(got["blocks"][name])
            for w, h in zip(want, have):
                if case == "f32":
                    assert _rel(h, w.numpy()) <= TOL, (r, name, tuple(w.shape))
                else:
                    assert float(np.abs(h - w.numpy()).max()) < BF16_PARAMS, (r, tuple(w.shape))


def test_reference_checkpoint_restores_with_shardings(tmp_path):
    """A checkpoint the reference package writes restores into each rank's
    blocks on (2, 4), read one leaf at a time: the blocks of the reference's
    tree, bit for bit, through ``restore(shardings=)`` and ``restore_on_mesh``."""
    jc = _jax_config("bf16")
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    JCheckpointer(str(tmp_path)).save(4, {"params": jp, "opt": jinit_state(jp)})
    JCheckpointer(str(tmp_path / "params")).save(4, jp)
    whole = params_from_jax(jax.tree.map(np.asarray, jp))
    cfg = shard_checks.train_config("bf16")
    shapes = param_shapes(cfg)
    mesh = dict(zip(("data", "model"), BIG))
    ck = Checkpointer(str(tmp_path))
    for r in (0, 5):
        coord = _coord(BIG, r)
        blob = ck.restore(4, {"params": shapes, "opt": init_state(shapes)},
                          shardings={"params": param_shardings(shapes, mesh),
                                     "opt": opt_shardings(shapes, mesh)},
                          device="cpu", coord=coord)
        want = tree_leaves(_blocks("bf16", whole, BIG, r))
        for w, h in zip(want, tree_leaves(blob["params"])):
            assert h.dtype == torch.bfloat16 and torch.equal(h, w)
        assert all(not t.any() for t in tree_leaves(blob["opt"]))
        alone = restore_on_mesh(Checkpointer(str(tmp_path / "params")), 4, shapes, mesh,
                                device="cpu", coord=coord)
        assert all(torch.equal(h, w) for h, w in zip(tree_leaves(alone), want))
    with pytest.raises(ValueError, match="meta device"):
        Checkpointer(str(tmp_path / "params")).restore(4, shapes)
    with pytest.raises(ValueError, match="has shape"):  # another config's checkpoint
        Checkpointer(str(tmp_path / "params")).restore(
            4, param_shapes(dataclasses.replace(cfg, d_model=2 * cfg.d_model)), device="cpu")


ARGS = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16", "--warmup", "1"]


def test_main_resumes_a_checkpoint_on_another_mesh(tmp_path):
    """``launch.train.main`` saves under ``--mesh-shape 2,2`` and resumes on
    ``4,1`` (and on one device): the resumed steps' losses are the
    uninterrupted run's (bf16, the reference's 2e-2), and the resume runs no
    collective but one barrier: each rank reads its blocks of the
    checkpoint, where the world once gathered the whole tree for a template."""
    import _torch_elastic_world

    whole = ttrain.main(ARGS + ["--steps", "3"])
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"]
    ttrain.main(ARGS + ["--steps", "2", "--total-steps", "3", "--mesh-shape", "2,2"] + ck)
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    cfg = ttrain.smoke_config("llama3.2-1b")
    run_cfg = ttrain.RunConfig(model=cfg, seq_len=16, global_batch=4, learning_rate=3e-4,
                               warmup_steps=1, total_steps=3)
    kw = dict(seed=0, steps=3, checkpoint_dir=str(tmp_path), checkpoint_every=1, log_every=1)
    ranks = run_world(_torch_elastic_world.resume_program, 4, cfg, run_cfg, "4,1", kw,
                      device="cpu", timeout=WORLD_TIMEOUT)
    for r in ranks:
        assert r["before_first_step"] == ["barrier"] and r["in_restore"] == []
        assert len(r["losses"]) == 1 and abs(r["losses"][0] - whole) < BF16_LOSS
    one = ttrain.main(ARGS + ["--steps", "4", "--total-steps", "3"] + ck[:2])
    assert np.isfinite(one) and Checkpointer(str(tmp_path)).latest_step() == 4

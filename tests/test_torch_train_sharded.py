"""The sharded train step on an 8-process gloo world (mesh (2, 4), data x
model, and two cases on (1, 8)), as the reference's
``sharded_train_step_matches`` check (``tests/_multidevice_checks.py``):
smoke llama, gemma2, olmo, llama-vision, whisper, rwkv6 (8 heads of 16,
and its own 2 heads of 64, which do not split 4 ways) and recurrentgemma
(its RG-LRU block on 2 of 8 gate blocks a rank, and on (1, 8) on 1), the
reference's
weights (``init_params`` from ``PRNGKey(0)``, the XATTN gates drawn
non-zero, carried across by ``params_from_jax``) and batches (``randint``
from ``PRNGKey(1)``; the encoder models' frontends drawn with numpy,
``sharding.checks.train_frontends``), two steps (the first at lr 0 under
warmup 1, the second moving the weights).  The compute splits over
"model" as the reference's GSPMD splits it (``sharding.tp``).

Every rank ends with its block (by ``param_shardings``) of the parameters
and AdamW moments the single-device ``train_step`` computes: the port's and
the reference's at 1e-4 of each leaf's largest magnitude in f32 (RWKV's at
``checks.RWKV_F32_TOL``, where Adam's second step magnifies its f32
rounding; the layers on blocks hold 1e-4 in ``test_torch_tp.py``), with one
microbatch, with two, with a batch of 3 that the data axes do not divide
(every rank then trains on the whole batch), with whole KV heads beside
split query heads, and on (1, 8); each step's loss and global gradient
norm to 1e-4.  In bf16 every rank's blocks are held to the reference's own
single-device step at the reference's tolerances (loss 2e-2, parameters
0.15).  Through ``comms.routes.observer``: the only all-gathers over a
model group are RWKV's channel-mix's (forward and backward), and a forward
pass makes one all-reduce over "model" for each split self- or
cross-attention block, each split MLP and each split RG-LRU block, two
for each split RWKV
time-mix, a reduce-scatter and an all-gather for each split channel-mix,
and one all-reduce for the embedding.  ``launch.train.main`` with ``--mesh-shape 2,2`` prints the
reference's lines once (rank 0), and resumes from its own checkpoint on
the same mesh.
"""
import collections
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.configs.base import RunConfig as JRunConfig
from repro.models import init_params as jinit_params
from repro.models.steps import train_step as jtrain_step
from repro.optim import init_state as jinit_state
from repro_torch.launch import train as ttrain
from repro_torch.configs.base import ATTN, ATTNX, LOCAL, RGLRU, RWKV, XATTN
from repro_torch.launch.mesh import run_world
from repro_torch.models.convert import (
    draw_xattn_gates,
    params_from_jax,
    tree_leaves,
    tree_map,
    tree_map2,
)
from repro_torch.models.steps import train_step
from repro_torch.models.transformer import param_shapes
from repro_torch.optim import init_state
from repro_torch.sharding import checks
from repro_torch.sharding.specs import compute_shardings, param_shardings

torch.set_num_threads(1)

WORLD_TIMEOUT = 300.0
F32 = [c for c, v in checks.TRAIN_CASES.items() if v[1] == "float32"]
TOL = 1e-4


def _mesh(case: str) -> dict:
    return dict(zip(("data", "model"), checks.TRAIN_CASES[case][4]))


def _coord(case: str, rank: int) -> dict:
    m = _mesh(case)["model"]
    return {"data": rank // m, "model": rank % m}


def _jax_config(case: str):
    arch, dtype, *_, changes = checks.TRAIN_CASES[case]
    return dataclasses.replace(jcfgs.smoke_config(arch), dtype=dtype, **dict(changes))


@functools.lru_cache(maxsize=None)
def _jax_params(case: str):
    """The reference's weights of a case as numpy arrays, the XATTN gates
    drawn (seed 0)."""
    tree = jax.tree.map(np.asarray, jinit_params(_jax_config(case), jax.random.PRNGKey(0)))
    draw_xattn_gates(tree, np.random.default_rng(0))
    return tree


def _jax_batch(inputs: dict, case: str, step: int) -> dict:
    """Step ``step``'s batch of a case for the reference's step."""
    batch = checks.TRAIN_CASES[case][2]
    out = {"tokens": jnp.asarray(np.asarray(inputs["tokens"][step, :batch]))}
    if case in inputs["frontends"]:
        out["frontend"] = jnp.asarray(inputs["frontends"][case][step, :batch].numpy())
    return out


@pytest.fixture(scope="module")
def world():
    """(inputs, the port's ranks' outputs)."""
    vocab = jcfgs.smoke_config(checks.TRAIN_ARCH).vocab_size
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8, checks.TRAIN_SEQ), 0,
                                           vocab), np.int32)
    params = {case: params_from_jax(_jax_params(case)) for case in checks.TRAIN_CASES}
    inputs = {"params": params, "tokens": torch.from_numpy(tokens),
              "frontends": checks.train_frontends(0)}
    return inputs, run_world(checks.train_program, checks.WORLD, inputs, device="cpu",
                             timeout=WORLD_TIMEOUT)


def _blocks(case: str, tree, rank: int):
    sh = param_shardings(param_shapes(checks.train_config(case)), _mesh(case))
    return tree_map2(lambda s, t: s.shard(t, coord=_coord(case, rank)), sh, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _single_device(case: str, inputs: dict):
    """The port's single-device steps on the same weights and batches."""
    cfg, run = checks.train_config(case), checks.train_run(case)
    batch = checks.TRAIN_CASES[case][2]
    params = tree_map(torch.clone, inputs["params"][case])
    opt = init_state(params)
    metrics = []
    for i, toks in enumerate(inputs["tokens"][:, :batch]):
        b = {"tokens": toks}
        if case in inputs["frontends"]:
            b["frontend"] = inputs["frontends"][case][i, :batch]
        params, opt, m = train_step(cfg, run, params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, params, opt, metrics


@pytest.mark.parametrize("case", F32)
def test_each_rank_holds_its_block_of_the_single_device_step(world, case):
    inputs, port = world
    cfg, params, opt, metrics = _single_device(case, inputs)
    for r in range(checks.WORLD):
        got = port[r][case]
        assert got["step"] == 2
        for k in ("loss", "grad_norm", "lr"):
            for step in range(2):
                want = metrics[step][k]
                assert abs(got["metrics"][step][k] - want) <= TOL * max(abs(want), 1.0), (r, k)
        for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
            want = tree_leaves(_blocks(case, tree, r))
            have = tree_leaves(got[name])
            assert len(want) == len(have)
            for w, h in zip(want, have):
                assert _rel(h, w.float().numpy()) <= checks.block_tol(case), (
                    r, name, tuple(w.shape))


def test_blocks_split_the_layers(world):
    """On (2, 4) each rank holds an eighth of wq, wo and the MLP (heads and
    FF over "model", d over "data") and half of wk and wv (2 KV heads do
    not split 4 ways, so only over "data")."""
    inputs, port = world
    full = inputs["params"]["f32"]["groups"][0][0]
    held = port[0]["f32"]["params"]["groups"][0][0]
    for sub, key, part in (("attn", "wq", 8), ("attn", "wo", 8), ("attn", "wk", 2),
                           ("attn", "wv", 2), ("mlp", "w_in", 8), ("mlp", "w_out", 8)):
        assert held[sub][key].size * part == full[sub][key].numel(), key


def test_bf16_blocks_hold_the_references_single_device_step(world):
    """The reference's own check: loss within 2e-2 and every parameter
    within 0.15 of its single-device bf16 step, here each rank's blocks."""
    inputs, port = world
    case = "bf16"
    jc = _jax_config(case)
    t_run = checks.train_run(case)
    jr = JRunConfig(model=jc, **{f.name: getattr(t_run, f.name)
                                 for f in dataclasses.fields(t_run) if f.name != "model"})
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    jo = jinit_state(jp)
    step = jax.jit(lambda p, o, b: jtrain_step(jc, jr, p, o, b))
    losses = []
    for toks in np.asarray(inputs["tokens"]):
        jp, jo, m = step(jp, jo, {"tokens": jnp.asarray(toks)})
        losses.append(float(m["loss"]))
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    for r in range(checks.WORLD):
        got = port[r][case]
        for s in range(2):
            assert abs(got["metrics"][s]["loss"] - losses[s]) < 2e-2, (r, s)
        for w, h in zip(tree_leaves(_blocks(case, want, r)), tree_leaves(got["params"])):
            assert float(np.abs(h - w.numpy()).max()) < 0.15


@pytest.mark.parametrize("case", F32)
def test_each_rank_holds_its_block_of_the_reference_s_step(world, case):
    """The reference's own single-device step (jitted, f32) on the same
    weights and batches: each rank's blocks of the parameters and moments
    and the steps' loss and gradient norm at 1e-4."""
    inputs, port = world
    jc = _jax_config(case)
    t_run = checks.train_run(case)
    jr = JRunConfig(model=jc, **{f.name: getattr(t_run, f.name)
                                 for f in dataclasses.fields(t_run) if f.name != "model"})
    jp = jax.tree.map(jnp.asarray, _jax_params(case))
    jo = jinit_state(jp)
    step = jax.jit(lambda p, o, b: jtrain_step(jc, jr, p, o, b))
    metrics = []
    for i in range(len(inputs["tokens"])):
        jp, jo, m = step(jp, jo, _jax_batch(inputs, case, i))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    f32 = lambda t: params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), t))  # noqa: E731
    for r in range(checks.WORLD):
        got = port[r][case]
        for s, want in enumerate(metrics):
            for k, v in want.items():
                assert abs(got["metrics"][s][k] - v) <= TOL * max(abs(v), 1.0), (r, s, k)
        for name, tree in (("params", jp), ("mu", jo.mu), ("nu", jo.nu)):
            for w, h in zip(tree_leaves(_blocks(case, f32(tree), r)), tree_leaves(got[name])):
                assert _rel(h, w.numpy()) <= checks.block_tol(case), (r, name, tuple(w.shape))


def _model_collectives(case: str) -> tuple:
    """(the collectives over "model" a forward pass of a case's config makes
    on its mesh, by kind; the all-gathers over it a step makes): one
    all-reduce for each split self- or cross-attention block, each split MLP,
    each split RG-LRU block (its gates on the rank's blocks) and the
    embedding; two all-reduces (the decay's partial sum, ``wo``), a
    reduce-scatter and an all-gather (the channel-mix) for each split RWKV
    layer, whose all-gathers a step makes twice (the reduce-scatter's
    backward)."""
    cfg, tp = checks.train_config(case), _mesh(case)["model"]
    heads = cfg.n_heads % tp == 0
    mlp = cfg.d_ff % tp == 0
    rwkv = (cfg.d_model // cfg.rwkv_head_dim) % tp == 0
    rec = bool(cfg.lru_width) and cfg.lru_width % tp == 0
    per_kind = {ATTN: heads + mlp, LOCAL: heads + mlp, XATTN: heads + mlp,
                ATTNX: 2 * heads + mlp, RWKV: 2 * rwkv, RGLRU: rec + mlp}
    reduces = sum(per_kind[k] * g.count for g in cfg.groups for k in g.pattern)
    reduces += cfg.encoder_layers * (heads + mlp) + (cfg.vocab_padded % tp == 0)
    rwkv_layers = rwkv * sum(g.count for g in cfg.groups for k in g.pattern if k == RWKV)
    want = collections.Counter(all_reduce=reduces, reduce_scatter=rwkv_layers,
                               all_gather=rwkv_layers)
    # the leaves stored split over "model" but computed whole (whisper's
    # learned positions; an RWKV layer whose heads do not divide the axis)
    # are gathered over it once a step
    plan = compute_shardings(param_shardings(param_shapes(cfg), _mesh(case)), gated=cfg.gated)
    whole = sum("model" in tree_leaves(c.gather.spec) for c in tree_leaves(plan))
    return +want, 2 * rwkv_layers + whole


@pytest.mark.parametrize("case", list(checks.TRAIN_CASES))
def test_split_compute_collectives(world, case):
    """The step's all-gathers over a model group are the split RWKV
    channel-mix's and those of the leaves stored split over "model" but
    computed whole (a split leaf is gathered over "data" only).  A forward
    pass makes exactly the collectives over "model" of
    :func:`_model_collectives` (two all-reduces a layer where attention and
    the MLP both split) and no other."""
    _, port = world
    want, step_gathers = _model_collectives(case)
    assert want["all_reduce"] > 1 or case == "rwkv_heads_whole"
    for r in range(checks.WORLD):
        got = port[r][case]
        model = tuple(got["model_ranks"])
        assert r in model and len(model) == _mesh(case)["model"]
        gathers = [ranks for op, _, ranks in got["step_collectives"] if op == "all_gather"]
        assert gathers.count(model) == step_gathers, (r, gathers)
        assert (len(gathers) > step_gathers) == (_mesh(case)["data"] > 1)  # FSDP over "data"
        over_model = [op for op, _, ranks in got["forward_collectives"] if ranks == model]
        assert collections.Counter(over_model) == want, (r, over_model)


ARGS = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
        "--warmup", "1"]
LINE = re.compile(r"^\[train\] (step \d+ loss [\d.]+ lr \S+ gnorm [\d.]+ \d+ tok/s|"
                  r"done: final loss [\d.]+|resumed from step \d+)$")


def test_main_with_a_mesh_prints_the_reference_lines_and_resumes(tmp_path, capfd):
    """``main`` starts a world of 4 for ``--mesh-shape 2,2``; rank 0 alone
    prints, in the reference's format.  The final loss is the one-device
    run's (bf16, 2e-2); a second call with more steps resumes from the
    world's checkpoint (the gathered tree, written by rank 0)."""
    one = ttrain.main(ARGS)
    capfd.readouterr()
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"]
    two = ttrain.main(ARGS + ["--mesh-shape", "2,2"] + ck)
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[train]")]
    assert [ln.split(" loss")[0] for ln in lines] == [
        "[train] step 0", "[train] step 1", "[train] done: final"], lines
    assert all(LINE.match(ln) for ln in lines), lines
    assert abs(one - two) < 2e-2
    three = ttrain.main(ARGS[:4] + ["3"] + ARGS[5:] + ["--mesh-shape", "2,2"] + ck)
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[train]")]
    assert lines[0] == "[train] resumed from step 2" and lines[1].startswith("[train] step 2")
    whole = ttrain.main(ARGS[:4] + ["3"] + ARGS[5:])
    assert abs(three - whole) < 2e-2


def test_train_world_refuses_an_expert_axis_it_cannot_serve():
    """mixtral at tp 2 (4 smoke experts, ep_shards 1): refused before any
    world starts."""
    with pytest.raises(ValueError, match="must hold E x ep_shards = 4 devices"):
        ttrain.main(["--arch", "mixtral-8x22b"] + ARGS + ["--mesh-shape", "4,2"])

"""Tensor parallelism over "model" (``repro_torch.sharding.tp``,
``specs.compute_shardings``) and the dry-run's serving steps split over it.

Without a world: a layer tells its weights' blocks from whole ones by their
shapes and raises on anything else; the compute plan keeps the model block
of exactly the leaves split in compute (the MLP's two only together) and
exchanges a gated ``w_in``; the exchange's sources tile the [gate | up]
columns once.  On a world of 4 gloo ranks, meshes (1, 4) and (2, 2)
(``tests/_torch_tp_world.py``): the vocabulary-parallel cross-entropy and
its gradient, the greedy pick (ties across blocks), the embedding lookup
and its gradient, and the gated exchange and its inverse, each against the
whole tensor's plain version; and the dry-run's ``prefill_step`` and
``decode_step`` (``launch.dryrun.serving_steps``) on each rank's blocks:
the next tokens, the logits gathered whole and the KV caches' blocks
(split over their KV heads) equal the single-device serving steps at f32
1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_tp_world as tpw
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import run_world
from repro_torch.models import decode as dec
from repro_torch.models.attention import self_attention
from repro_torch.models.common import mlp_apply
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.models.transformer import DistContext, param_shapes
from repro_torch.sharding import specs, tp

torch.set_num_threads(1)

TOL = 1e-4
WORLD_TIMEOUT = 300.0


def _dist(data: int, model: int) -> DistContext:
    return DistContext(mesh={"data": data, "model": model})


@pytest.mark.parametrize("have,whole,model,want", [
    (32, 32, 4, False), (8, 32, 4, True), (32, 32, 1, False), (12, 12, 8, False)])
def test_is_block_tells_blocks_from_whole(have, whole, model, want):
    assert tp.is_block("w", have, whole, _dist(1, model)) is want


@pytest.mark.parametrize("have,whole,model", [(16, 32, 4), (8, 32, 1), (3, 12, 8)])
def test_is_block_raises_on_any_other_shape(have, whole, model):
    with pytest.raises(ValueError, match="neither whole nor this rank's block"):
        tp.is_block("w", have, whole, _dist(1, model))


def test_layers_raise_on_mixed_or_odd_blocks():
    """An MLP with a block of w_in beside a whole w_out, and attention with
    a head count that is neither whole nor the rank's, raise: nothing
    falls back."""
    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    dist = _dist(1, 4)
    x = torch.zeros((1, 3, cfg.d_model))
    p = {"w_in": torch.zeros((cfg.d_model, 2 * cfg.d_ff // 4)),
         "w_out": torch.zeros((cfg.d_ff, cfg.d_model))}
    with pytest.raises(ValueError, match="not both whole or both blocks"):
        mlp_apply(cfg, p, x, dist)
    a = {"wq": torch.zeros((cfg.d_model, 2, cfg.head_dim_)),
         "wk": torch.zeros((cfg.d_model, 2, cfg.head_dim_)),
         "wv": torch.zeros((cfg.d_model, 2, cfg.head_dim_)),
         "wo": torch.zeros((2, cfg.head_dim_, cfg.d_model))}
    with pytest.raises(ValueError, match="attn/wq heads: 2 of 4"):
        self_attention(cfg, a, x, torch.arange(3), dist=dist)


def test_compute_shardings_keep_the_split_leaves_model_blocks():
    """On (2, 4): self-attention's wq, wo, the MLP, the embedding keep their
    model block (gathered over "data" only), wk/wv (2 KV heads) and the norms
    have none to keep; w_in is exchanged.  An FF width of 6 (12 = 2·ff
    splits 4 ways, 6 does not) keeps neither MLP leaf's block."""
    cfg = smoke_config("llama3.2-1b")
    mesh = {"data": 2, "model": 4}
    for d_ff, mlp_split in ((cfg.d_ff, True), (6, False)):
        c = dataclasses.replace(cfg, d_ff=d_ff)
        plan = specs.compute_shardings(specs.param_shardings(param_shapes(c), mesh),
                                       gated=c.gated)
        layer = plan["groups"][0][0]
        kept = {k: "model" not in tree_leaves(v.gather.spec)
                and "model" in tree_leaves(v.storage.spec)
                for k, v in {**{f"attn/{w}": layer["attn"][w] for w in layer["attn"]},
                             **{f"mlp/{w}": layer["mlp"][w] for w in layer["mlp"]},
                             "embed/tok": plan["embed"]["tok"]}.items()}
        assert kept == {"attn/wq": True, "attn/wk": False, "attn/wv": False, "attn/wo": True,
                        "mlp/w_in": mlp_split, "mlp/w_out": mlp_split, "embed/tok": True}
        assert layer["mlp"]["w_in"].exchange is mlp_split
        assert not layer["mlp"]["w_out"].exchange
        assert layer["ln1"]["scale"].gather == layer["ln1"]["scale"].storage


@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_gated_sources_tile_the_columns_once(n):
    """Over n ranks (f = ff / n columns a half), rank r's compute halves are
    the gate columns [r·f, (r+1)·f) and the up columns ff + [r·f, (r+1)·f),
    each a piece of one storage block of 2f columns: together every column
    of [gate | up] exactly once."""
    seen = []
    for r in range(n):
        for half, (src, off) in enumerate(tp._gated_sources(n, r)):
            start = src * 2 + off  # in units of f
            assert start == (r if half == 0 else n + r)
            seen.append(start)
    assert sorted(seen) == list(range(2 * n))


@pytest.fixture(scope="module")
def world():
    inp = tpw.inputs()
    return inp, run_world(tpw.program, tpw.WORLD, inp, device="cpu", timeout=WORLD_TIMEOUT)


def _rank_coord(dims, rank):
    return rank // dims[1], rank % dims[1]


@pytest.mark.parametrize("dims", tpw.MESHES)
def test_vocab_ops_and_exchange_equal_the_whole_versions(world, dims):
    inp, ranks = world
    n = dims[1]
    z = inp["logits"].clone().requires_grad_()
    want = -torch.gather(torch.log_softmax(z, -1), -1, inp["labels"][..., None])[..., 0]
    (want_grad,) = torch.autograd.grad(want.sum(), z)
    table = inp["table"].clone().requires_grad_()
    emb = table[inp["ids"]]
    (emb_grad,) = torch.autograd.grad((emb * inp["embed_weight"]).sum(), table)
    gate, up = inp["w_in"].chunk(2, dim=-1)
    for rank, got in enumerate(ranks):
        _, m = _rank_coord(dims, rank)
        out = got[f"ops_{dims[0]}x{dims[1]}"]
        np.testing.assert_allclose(out["nll"], want.detach().numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["nll_grad"], want_grad.chunk(n, -1)[m].numpy(),
                                   rtol=TOL, atol=TOL)
        assert out["argmax"].tolist() == inp["tied"].argmax(-1).tolist()
        assert out["argmax"].tolist()[:2] == [5, 20]  # the first of the tied maxima
        np.testing.assert_array_equal(out["embed"], emb.detach().numpy())
        np.testing.assert_allclose(out["embed_grad"], emb_grad.chunk(n, 0)[m].numpy(),
                                   rtol=TOL, atol=TOL)
        compute = torch.cat([gate.chunk(n, -1)[m], up.chunk(n, -1)[m]], -1)
        np.testing.assert_array_equal(out["w_in_compute"], compute.numpy())
        np.testing.assert_array_equal(out["w_in_back"], inp["w_in"].chunk(n, -1)[m].numpy())


def _single_device(case: str, inp: dict):
    """The single-device prefill and greedy decode steps of the same
    weights and prompts: each step's tokens and logits, and the caches
    after prefill and at the end."""
    cfg = tpw.serve_config(case)
    params = inp["serve_params"][case]
    cap = tpw.SERVE_PROMPT + tpw.SERVE_STEPS
    with torch.no_grad():
        logits, caches = dec.prefill(cfg, params, inp["prompts"], capacity=cap)
        first = tree_map(torch.clone, caches)
        toks, lg = [logits.argmax(-1)], [logits]
        for i in range(tpw.SERVE_STEPS):
            logits, caches = dec.decode_step(cfg, params, caches, toks[-1][:, None].int(),
                                             tpw.SERVE_PROMPT + i)
            toks.append(logits.argmax(-1))
            lg.append(logits)
    return cfg, toks, lg, first, caches


@pytest.mark.parametrize("case", list(tpw.SERVE_CASES))
def test_dryrun_serving_steps_equal_the_single_device_steps(world, case):
    """Each rank's next tokens are its slot's, its logits are its vocabulary
    block of its slot's (so gathered over "model" they are the whole
    logits), and its caches are its blocks (batch slot, KV heads) of the
    single-device caches, after prefill and after three decode steps, at
    f32 1e-4."""
    inp, ranks = world
    cfg, toks, lg, first, last = _single_device(case, inp)
    dims = tpw.SERVE_CASES[case][1]
    mesh = dict(zip(("data", "model"), dims))
    c_sh = specs.cache_shardings(dec.init_caches(cfg, tpw.SERVE_BATCH, tpw.SERVE_PROMPT
                                                 + tpw.SERVE_STEPS, device="meta"), mesh)
    kv = [s for s in tree_leaves(c_sh) if len(s.spec) == 5]
    assert kv and all(s.spec[3] == "model" for s in kv)  # split over KV heads
    rows = tpw.SERVE_BATCH // dims[0]
    for rank, got in enumerate(ranks):
        d, m = _rank_coord(dims, rank)
        out = got[case]
        sl = slice(d * rows, (d + 1) * rows)
        for step, (t, l) in enumerate(zip(toks, lg)):
            assert out["tokens"][step].tolist() == t[sl].tolist(), (rank, step)
            whole = np.concatenate([ranks[d * dims[1] + j][case]["logits"][step]
                                    for j in range(dims[1])], -1)
            np.testing.assert_allclose(whole, l[sl].numpy(), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(out["logits"][step], l[sl].chunk(dims[1], -1)[m].numpy(),
                                       rtol=TOL, atol=TOL)
        coord = {"data": d, "model": m}
        for key, want in (("prefill_caches", first), ("caches", last)):
            for s, w, h in zip(tree_leaves(c_sh), tree_leaves(want), tree_leaves(out[key])):
                np.testing.assert_allclose(h, s.block(w, coord).numpy(), rtol=TOL, atol=TOL)

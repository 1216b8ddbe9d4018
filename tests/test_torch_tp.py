"""Tensor parallelism over "model" (``repro_torch.sharding.tp``,
``specs.compute_shardings``) and the dry-run's serving steps split over it.

Without a world: a layer tells its weights' blocks from whole ones by their
shapes and raises on anything else; the compute plan keeps the model block
of exactly the leaves split in compute (the MLP's two only together, the
RG-LRU's with its gates only where its width splits) and exchanges a gated
``w_in``; the exchange's sources tile the [gate | up] columns once; the
RG-LRU's rank-columns function joined over n ranks is the whole
block-diagonal product.  On a world of 4 gloo ranks, meshes (1, 4) and
(2, 2) (``tests/_torch_tp_world.py``): the vocabulary-parallel
cross-entropy and its gradient, the greedy pick (ties across blocks), the
embedding lookup and its gradient, and the gated exchange and its inverse,
each against the whole tensor's plain version; cross-attention (KV heads
whole beside the rank's heads, and split), RWKV's time-mix and
channel-mix and the RG-LRU block (its gates on the rank's blocks) on each
rank's blocks, forward and gradients, against the whole layer at f32 1e-4;
the RG-LRU's gates where a block spans ranks (a block count of 2 over 4
ranks), each rank's columns and the gradients of its channels and of the
whole gates against the whole block-diagonal products; and the dry-run's
``prefill_step`` and ``decode_step`` (``launch.dryrun.serving_steps``) on
each rank's blocks: the next tokens, the logits gathered whole and the
caches' blocks (the self- and cross-attention K/V split over their KV
heads, RWKV's state over its heads, the RG-LRU's h and conv tail over its
channels) equal the single-device serving steps at f32 1e-4.
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


@pytest.mark.parametrize("head_dim,split", [(16, True), (64, False)])
def test_compute_shardings_split_rwkv_only_together(head_dim, split):
    """On (2, 4): RWKV's nine split leaves keep their model blocks together,
    where its heads (d / head_dim) divide the axis: 8 heads of 16 do, 2 of
    64 do not (``wr``'s columns would split 4 ways and cut a head), and then
    none does.  ``cm_r``, ``decay_A`` and the mixes are stored whole over
    "model" and gathered whole either way (the layer narrows them)."""
    cfg = dataclasses.replace(smoke_config("rwkv6-1.6b"), rwkv_head_dim=head_dim)
    plan = specs.compute_shardings(
        specs.param_shardings(param_shapes(cfg), {"data": 2, "model": 4}), gated=cfg.gated)
    layer = plan["groups"][0][0]["tm_cm"]
    kept = {k for k, c in layer.items() if c.gather != c.storage
            and "model" not in tree_leaves(c.gather.spec)}
    assert kept == ({"wr", "wk", "wv", "wg", "wo", "decay_B", "ln_scale", "cm_k", "cm_v"}
                    if split else set())
    for k in ("cm_r", "decay_A", "mu", "cmu", "w0", "u"):
        assert "model" not in tree_leaves(layer[k].storage.spec), k


def test_compute_shardings_split_cross_attention():
    """llama-vision's XATTN projections on (2, 4): wq and wo keep their model
    blocks (4 heads), wk and wv (2 KV heads) have none to keep."""
    cfg = smoke_config("llama-3.2-vision-11b")
    plan = specs.compute_shardings(
        specs.param_shardings(param_shapes(cfg), {"data": 2, "model": 4}), gated=cfg.gated)
    xattn = plan["groups"][0][4]["xattn"]
    assert {k for k, c in xattn.items() if "model" in tree_leaves(c.storage.spec)
            and "model" not in tree_leaves(c.gather.spec)} == {"wq", "wo"}


def test_rwkv_and_cross_attention_raise_on_mixed_blocks():
    """An RWKV layer with ``wr``'s block beside a whole ``wo``, and a
    cross-attention with an odd head count, raise: nothing falls back."""
    from repro_torch.models import attention, rwkv

    cfg = dataclasses.replace(smoke_config("rwkv6-1.6b"), dtype="float32", rwkv_head_dim=16)
    p = rwkv.rwkv_params(cfg, torch.Generator().manual_seed(0))
    p["wr"] = p["wr"][:, :cfg.d_model // 4]
    with pytest.raises(ValueError, match=r"tm_cm: blocks \['wr'\] beside whole"):
        rwkv.tp_split(cfg, p, _dist(1, 4))
    v = dataclasses.replace(smoke_config("llama-3.2-vision-11b"), dtype="float32")
    a = attention.attn_params(v, torch.Generator().manual_seed(0), kv_input_dim=v.frontend_dim)
    a["wq"] = a["wq"][:, :3]
    with pytest.raises(ValueError, match="xattn/wq heads: 3 of 4"):
        attention.cross_kv(v, a, torch.zeros((1, 2, v.frontend_dim)), _dist(1, 4))


@pytest.mark.parametrize("model,lru_width,kept,gates", [
    (4, 128, True, True), (8, 128, True, True), (16, 128, True, False),
    (16, 8 * 3, False, False)])
def test_compute_shardings_split_griffin_together(model, lru_width, kept, gates):
    """On (1, n): the RG-LRU's six channel leaves keep their model blocks
    where its width W divides the axis, and none does where it does not;
    its gates (8 blocks) are stored split, and keep their blocks, only where
    n divides 8, else stored and gathered whole (the layer narrows them)."""
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"), lru_width=lru_width)
    plan = specs.compute_shardings(
        specs.param_shardings(param_shapes(cfg), {"data": 1, "model": model}), gated=cfg.gated)
    rec = plan["groups"][0][0]["rec"]
    split = {k for k, c in rec.items() if "model" in tree_leaves(c.storage.spec)
             and "model" not in tree_leaves(c.gather.spec)}
    channels = {"w_gate", "w_in", "conv_w", "conv_b", "lam", "w_out"}
    assert split == (channels if kept else set()) | ({"gate_a", "gate_x"} if gates else set())
    for k in ("gate_a", "gate_x"):
        assert ("model" in tree_leaves(rec[k].storage.spec)) is gates


def test_griffin_raises_on_mixed_blocks():
    """An RG-LRU block with ``w_in``'s block beside a whole ``w_out``, or with
    its gates' blocks beside whole channels, raises: nothing falls back."""
    from repro_torch.models import griffin

    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"), dtype="float32")
    p = griffin.rglru_params(cfg, torch.Generator().manual_seed(0))
    q = dict(p, w_in=p["w_in"][:, :32])
    with pytest.raises(ValueError, match=r"rec: blocks \['w_in'\] beside whole"):
        griffin.rglru_block(cfg, q, torch.zeros((1, 3, cfg.d_model)), _dist(1, 4))
    q = dict(p, gate_a=p["gate_a"][:2])
    with pytest.raises(ValueError, match="rec: gate_a's blocks beside whole channels"):
        griffin.tp_split(cfg, q, _dist(1, 4))
    q = dict(p, lam=p["lam"][:48])
    with pytest.raises(ValueError, match="rec/lam: 48 of 128 is neither whole"):
        griffin.tp_split(cfg, q, _dist(1, 4))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_block_columns_joined_over_ranks_are_the_block_diagonal_product(n):
    """Rank r's columns of u @ blockdiag(w) over n ranks (its own blocks on
    its channels where n divides the 8 blocks; at 16 its half of one
    block's columns on that block's input), joined over the ranks, equal
    the whole product; an n that neither divides nor is a multiple of the
    block count raises."""
    from repro_torch.models import griffin

    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.standard_normal((8, 6, 6)))
    u = torch.from_numpy(rng.standard_normal((2, 3, 8 * 6)))
    joined = torch.cat([griffin.block_columns(w, u, r, n) for r in range(n)], -1)
    torch.testing.assert_close(joined, griffin._block_linear(w, u), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="8 blocks over a model axis of 3"):
        griffin.block_columns(w, u, 0, 3)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_block_columns_parts_sum_to_the_columns(n, parts):
    """Over the data axes each rank contracts over its part of each block's
    input channels (``part``): the parts' partial products summed are the
    rank's whole columns, on its own blocks (n divides the 8 blocks) and on
    its columns of a block spanning ranks (n = 16); a block's channels that
    the parts do not divide raise."""
    from repro_torch.models import griffin

    rng = np.random.default_rng(n + parts)
    w = torch.from_numpy(rng.standard_normal((8, 6, 6)))
    u = torch.from_numpy(rng.standard_normal((2, 3, 8 * 6)))
    for r in range(n):
        summed = sum(griffin.block_columns(w, u, r, n, part=(i, parts)) for i in range(parts))
        torch.testing.assert_close(summed, griffin.block_columns(w, u, r, n),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="a block's 6 input channels over 4 data ranks"):
        griffin.block_columns(w, u, 0, n, part=(0, 4))


@pytest.mark.parametrize("chunks,softcap", [(2, 0.0), (4, 0.0), (2, 30.0), (4, 30.0)])
def test_split_softmax_equals_attention_over_the_whole_cache(chunks, softcap):
    """Decode attention over a cache split in ``chunks`` sequence chunks:
    each chunk's part (``attention._softmax_part``: its row maximum, sum of
    exponentials and unnormalised output), merged by ``tp.merge_softmax``
    (the max and sum all-reduces done over the stacked parts), equals
    ``_attend_dense`` over the whole cache at f32 1e-5, with gemma2's
    attention softcap on or off.  The last chunk's every slot is unwritten
    (pos -1): its maximum is NEG_INF's and it weighs 0, with no NaN."""
    from repro_torch.models import attention

    cfg = dataclasses.replace(smoke_config("gemma2-9b"), dtype="float32", attn_softcap=softcap)
    rng = np.random.default_rng(chunks)
    B, G, M, dh, cap = 2, 2, 2, cfg.head_dim_, 48
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    q, k, v = f32(B, 1, G, M, dh) * 3, f32(B, cap, G, dh) * 3, f32(B, cap, G, dh)
    c = cap // chunks
    k_pos = torch.full((cap,), -1, dtype=torch.int32)
    k_pos[: cap - c] = torch.from_numpy(rng.permutation(cap - c).astype(np.int32))
    q_pos = torch.tensor([cap - c - 1], dtype=torch.int32)
    whole = attention._attend_dense(cfg, q, k, v, attention._mask_bias(q_pos, k_pos, 0, True))
    parts = [attention._softmax_part(cfg, q, k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c],
                                     attention._mask_bias(q_pos, k_pos[i * c:(i + 1) * c], 0,
                                                          True))
             for i in range(chunks)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    assert float(m[-1].max()) < -1e38  # the unwritten chunk

    def reduce(t, op):  # an all-reduce over the stacked chunks, in place
        t.copy_((t.amax(0) if op == torch.distributed.ReduceOp.MAX else t.sum(0)).expand_as(t))

    out = tp.merge_softmax(m, l, o, reduce)
    for i in range(chunks):
        got = out[i].permute(0, 3, 1, 2, 4)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-5 * float(whole.abs().max()))


def test_compute_shardings_keep_the_fsdp_blocks():
    """With ``keep_axes=("data",)`` on (2, 4) the leaves of
    ``DATA_SPLIT_COMPUTE`` keep their FSDP block over "data" besides their
    model block (gemma2's attention, MLP and tied table are not gathered at
    all; RWKV's whole ``decay_A`` and ``cm_r`` keep their rows), while the
    experts' weights, cross-attention's and the leaves with no FSDP dim are
    gathered as without it."""
    mesh = {"data": 2, "model": 4}

    def plans(arch, **changes):
        cfg = dataclasses.replace(smoke_config(arch), **changes)
        sh = specs.param_shardings(param_shapes(cfg), mesh)
        return (specs.compute_shardings(sh, gated=cfg.gated),
                specs.compute_shardings(sh, gated=cfg.gated, keep_axes=("data",)))

    def kept(plan):
        out = set()
        specs.map_with_path(lambda path, c: out.add(path) if "data" in tree_leaves(
            c.storage.spec) and "data" not in tree_leaves(c.gather.spec) else None, plan)
        return out

    base, keep = plans("gemma2-9b")
    assert not kept(base)
    assert kept(keep) == {"embed/tok"} | {f"groups/0/{i}/{w}" for i in (0, 1) for w in (
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_in", "mlp/w_out")}
    layer = keep["groups"][0][0]
    for w in ("wq", "wo"):
        assert set(tree_leaves(layer["attn"][w].gather.spec)) <= {None}, w
    assert layer["ln1"]["scale"].gather == base["groups"][0][0]["ln1"]["scale"].gather
    _, keep = plans("rwkv6-1.6b", rwkv_head_dim=16)
    assert {p.rsplit("/", 1)[1] for p in kept(keep)} == {
        "tok", "head", "wr", "wk", "wv", "wg", "wo", "decay_A", "cm_k", "cm_v", "cm_r"}
    _, keep = plans("recurrentgemma-9b")
    assert {p.rsplit("/", 1)[1] for p in kept(keep)} == {
        "tok", "w_gate", "w_in", "w_out", "wq", "wk", "wv", "wo"}
    base, keep = plans("dbrx-132b")
    assert not any("moe/" in p for p in kept(keep))
    base, keep = plans("llama-3.2-vision-11b")
    assert not any("xattn/" in p for p in kept(keep))


def test_layers_raise_on_mixed_fsdp_blocks():
    """With a data split in the context, a layer whose FSDP blocks are not
    all blocks or all whole, a decode cache whose sequence is neither whole
    nor the rank's chunk, and cross-attention on FSDP blocks raise; the
    data-axis operators refuse a tensor that requires grad."""
    from repro_torch.models import attention, griffin, rwkv

    dist = DistContext(mesh={"data": 2, "model": 1}, data_split=("data",))
    cfg = dataclasses.replace(smoke_config("gemma2-9b"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    d = cfg.d_model
    p = attention.attn_params(cfg, gen)
    half = dict(p, wq=p["wq"][: d // 2])
    with pytest.raises(ValueError, match=r"attn: FSDP blocks \['wq'\] beside whole"):
        attention.qkv_proj(cfg, half, torch.zeros((1, 1, d)), torch.zeros(1, dtype=torch.int32),
                           dist)
    with pytest.raises(ValueError, match="attn/wk rows: 48 of 128 is neither whole"):
        attention.qkv_proj(cfg, dict(p, wk=p["wk"][:48]), torch.zeros((1, 1, d)),
                           torch.zeros(1, dtype=torch.int32), dist)
    cache = attention.init_kv_cache(cfg, 1, 64)
    cache["k"] = cache["k"][:, :24]
    with pytest.raises(ValueError, match="attn cache sequence: 24 of 64 is neither whole"):
        attention.decode_attention(cfg, p, torch.zeros((1, 1, d)), 3, cache, dist=dist)
    blocks = dict(p, wq=p["wq"][: d // 2], wo=p["wo"][..., : d // 2])
    with pytest.raises(ValueError, match="cross-attention computes on weights whole"):
        attention.cross_kv(cfg, blocks, torch.zeros((1, 2, d)), dist)
    rc = dataclasses.replace(smoke_config("rwkv6-1.6b"), dtype="float32")
    r = rwkv.rwkv_params(rc, gen)
    with pytest.raises(ValueError, match=r"tm_cm: FSDP blocks \['cm_r'\] beside whole"):
        rwkv.fsdp_split(rc, dict(r, cm_r=r["cm_r"][: d // 2]), dist)
    gc = dataclasses.replace(smoke_config("recurrentgemma-9b"), dtype="float32")
    g = griffin.rglru_params(gc, gen)
    with pytest.raises(ValueError, match=r"rec: FSDP blocks \['w_out'\] beside whole"):
        griffin.fsdp_split(gc, dict(g, w_out=g["w_out"][:, : d // 2]), dist)
    with pytest.raises(RuntimeError, match="serve decode only"):
        tp.data_block(torch.zeros((1, d), requires_grad=True), dist)


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


@pytest.mark.parametrize("case", list(tpw.LAYER_CASES))
@pytest.mark.parametrize("dims", tpw.MESHES)
def test_layers_on_blocks_equal_the_whole_layer(world, dims, case):
    """Each rank's output of the layer on its blocks is the whole layer's;
    the gradients of its input (and frontend states) are the whole ones, of
    a leaf it holds as a block that block of the whole one, of any other
    leaf the whole one (summed over the model axis where the rank used a
    part of it), at f32 1e-4 of each tensor's largest magnitude."""
    inp, ranks = world
    cfg = tpw.layer_config(case)
    p = {k: t.clone().requires_grad_() for k, t in inp["layers"][case].items()}
    x = inp["layer_x"].clone().requires_grad_()
    enc = inp["layer_enc"][case].clone().requires_grad_()
    y = tpw.layer_apply(case, cfg, p, x, enc, None)
    keys = (["x", "enc"] if case.startswith("xattn") else ["x"]) + list(p)
    leaves = {"x": x, "enc": enc, **p}
    grads = dict(zip(keys, torch.autograd.grad((y * inp["layer_w"]).sum(),
                                               [leaves[k] for k in keys],
                                               allow_unused=True, materialize_grads=True)))
    n = dims[1]
    for rank, got in enumerate(ranks):
        m = _rank_coord(dims, rank)[1]
        out = got[f"layers_{dims[0]}x{dims[1]}"][case]
        blocks, cut = tpw.layer_blocks(case, {k: grads[k] for k in p}, n, m)
        assert any(cut.values())
        if not case.startswith("xattn"):
            assert tpw.layer_split(case, cfg, tpw.layer_blocks(case, p, n, m)[0], _dist(*dims))
        np.testing.assert_allclose(out["out"], y.detach().numpy(), rtol=0,
                                   atol=TOL * float(y.detach().abs().max()))
        for k in keys:
            want = (blocks[k] if k in p else grads[k]).numpy()
            np.testing.assert_allclose(out["grads"][k], want, rtol=0,
                                       atol=TOL * max(float(np.abs(want).max()), 1e-30),
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("dims", tpw.MESHES)
def test_griffin_gates_across_ranks_equal_the_block_diagonal_product(world, dims):
    """The RG-LRU's gates on whole leaves of ``CROSS_BLOCKS`` (2) blocks: on
    (1, 4) each block spans 2 ranks (a gather of u's channels, each rank's
    columns of its block), on (2, 2) each rank takes its block.  Each rank's
    columns of both products are the whole block-diagonal products'; the
    gradient of its channels of u is its block of the whole gradient (the
    ranks' parts summed by the gather's reduce-scatter backward), and of
    each gate the whole gradient, at f32 1e-4."""
    from repro_torch.models import griffin

    inp, ranks = world
    g = inp["cross"]
    u = g["u"].clone().requires_grad_()
    p = {k: g[k].clone().requires_grad_() for k in ("gate_a", "gate_x")}
    za, zx = griffin._block_linear(p["gate_a"], u), griffin._block_linear(p["gate_x"], u)
    grads = torch.autograd.grad((za * g["weight"][0] + zx * g["weight"][1]).sum(),
                                [u, p["gate_a"], p["gate_x"]])
    n = dims[1]
    for rank, got in enumerate(ranks):
        m = _rank_coord(dims, rank)[1]
        out = got[f"cross_{dims[0]}x{dims[1]}"]
        wants = {"za": za.detach().chunk(n, -1)[m], "zx": zx.detach().chunk(n, -1)[m],
                 "u": grads[0].chunk(n, -1)[m], "gate_a": grads[1], "gate_x": grads[2]}
        for k, want in wants.items():
            assert out[k].shape == want.shape, (rank, k)
            np.testing.assert_allclose(out[k], want.numpy(), rtol=0,
                                       atol=TOL * float(want.abs().max()),
                                       err_msg=f"rank {rank} {k}")


def _single_device(case: str, inp: dict):
    """The single-device prefill and greedy decode steps of the same
    weights and prompts: each step's tokens and logits, and the caches
    after prefill and at the end."""
    cfg = tpw.serve_config(case)
    params = inp["serve_params"][case]
    _, prompt, n_steps, cap = tpw.serve_shape(case)
    with torch.no_grad():
        logits, caches = dec.prefill(cfg, params, tpw.prompts(inp, case),
                                     frontend=inp["frontends"].get(case), capacity=cap)
        first = tree_map(torch.clone, caches)
        toks, lg = [logits.argmax(-1)], [logits]
        for i in range(n_steps):
            logits, caches = dec.decode_step(cfg, params, caches, toks[-1][:, None].int(),
                                             prompt + i)
            toks.append(logits.argmax(-1))
            lg.append(logits)
    return cfg, toks, lg, first, caches


@pytest.mark.parametrize("case", list(tpw.SERVE_CASES))
def test_dryrun_serving_steps_equal_the_single_device_steps(world, case):
    """Each rank's next tokens are its slot's, its logits are its vocabulary
    block of its slot's (so gathered over "model" they are the whole
    logits), and its caches are its blocks (batch slot; the self- and
    cross-attention K/V's KV heads, RWKV's state's heads and token shifts'
    channels, the RG-LRU's h and conv tail's channels) of the single-device
    caches, after prefill and after the decode steps, at f32 1e-4.  At batch
    1 (``B1_CASES``) the batch is whole on every rank and the self-attention
    K/V are the rank's sequence chunk over "data" besides its KV heads; their
    decode writes land in both chunks (and gemma2's and recurrentgemma's
    LOCAL rings wrap), and no decode step gathers more than an activation:
    every weight and cache is computed on as the rank's block."""
    inp, ranks = world
    cfg, toks, lg, first, last = _single_device(case, inp)
    batch, prompt, n_steps, cap = tpw.serve_shape(case)
    dims = tpw.SERVE_CASES[case][1]
    mesh = dict(zip(("data", "model"), dims))
    c_sh = specs.cache_shardings(dec.init_caches(cfg, batch, cap, device="meta"), mesh)
    heads = {}  # the leaves split over heads: their head dim over "model"
    specs.map_with_path(lambda path, s: heads.setdefault(path.rsplit("/", 1)[-1], []).append(
        s.spec[2 if path.endswith("state") else 3]) if len(s.spec) == 5 else None, c_sh)
    assert set(heads) == ({"state"} if "rwkv" in case else
                          {"k", "v", "ck", "cv"} if "vision" in case else {"k", "v"})
    assert all(e == "model" for es in heads.values() for e in es), heads
    channels = []  # the RG-LRU's h and conv tail: their channels over "model"
    specs.map_with_path(lambda path, s: channels.append(s.spec[-1]) if path.endswith(
        ("/h", "/conv")) else None, c_sh)
    assert len(channels) == (2 * 4 if "griffin" in case else 0)  # 4 stacks of RGLRU layers
    assert all(e == "model" for e in channels), channels
    seq = []  # the self-attention K/V: their batch and sequence dims
    specs.map_with_path(lambda path, s: seq.append(s.spec[1:3]) if path.endswith(("/k", "/v"))
                        else None, c_sh)
    b1 = case in tpw.B1_CASES
    assert ("rwkv" in case) == (not seq)
    want = (None, "data") if b1 else (("data",) if dims[0] > 1 else None, None)
    assert all(tuple(e) == want for e in seq), seq
    if b1:
        steps = np.arange(prompt, prompt + n_steps)
        if "rwkv" not in case:  # the LOCAL ring's writes land in both chunks and wrap
            assert {int(p % cfg.window >= cfg.window // 2) for p in steps} == {0, 1}
            assert 0 in steps % cfg.window
        if "gemma2" in case:  # and so do the global cache's
            assert {int(p >= cap // 2) for p in steps} == {0, 1}
        # the largest gather: RWKV's token shifts (count, B, d) f32, which
        # cache_shardings splits over "model" and decode takes whole; any
        # weight or K/V block is larger
        most = 4 * batch * cfg.d_model * max(g.count for g in cfg.groups)
        for rank, got in enumerate(ranks):
            gathers = [b for op, b in got[case]["decode_collectives"] if op == "all_gather"]
            assert gathers and max(gathers) <= most, (rank, max(gathers), most)
    rows = batch // dims[0] if batch % dims[0] == 0 else batch
    for rank, got in enumerate(ranks):
        d, m = _rank_coord(dims, rank)
        out = got[case]
        sl = slice(d * rows, (d + 1) * rows) if rows < batch else slice(0, batch)
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

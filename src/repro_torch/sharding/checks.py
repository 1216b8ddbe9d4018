"""The model across ranks, driven as one rank's programs for
``repro_torch.launch.mesh.run_world``: the port's counterparts of the
reference's multi-device checks of the sharded MoE and the sharded train
step (``tests/_multidevice_checks.py``).

:func:`moe_program` runs ``forward`` with a ``DistContext`` for each case
of :data:`MOE_CASES` (the expert-parallel layer's strategies, capacity
factors and layouts, and the layouts it refuses) on a world of 8, each rank
holding its virtual expert of each layer, and returns its slot of the
logits and the aux loss.  :func:`train_program` runs the sharded
``train_step`` twice (the warm-up's step at lr 0, then one that moves the
weights) for each case of :data:`TRAIN_CASES`, its compute split over
"model", on a (2, 4) mesh (two cases on (1, 8)) and returns the rank's
blocks of the parameters and moments, the steps' metrics and the
collectives the first step and a forward pass made.
The tests hold them against the JAX package's outputs; on the card, a
world on CUDA tensors is held against a world on the host
(:func:`compare_moe`, :func:`compare_train`).  :func:`long_decode_report`
runs the dry-run's serving decode at batch 1 (``launch.dryrun.serving_steps``:
the weights' FSDP blocks and the KV caches' sequence chunks over "data")
on weights and caches drawn from a seed (:func:`long_decode_inputs`), which
:func:`long_decode_single` runs on one device for reference.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

WORLD = 8
MOE_ARCH = "dbrx-132b"  # the reference's check: 4 experts x 2 shards at smoke width
MOE_BATCH = 4
# name -> (mesh dims, sequence, dtype, capacity factor, strategy, a2a chunks,
# ep_axes, ep_shards).  At 16 positions (the reference's check) every slice
# of 8 tokens fits the least capacity, 8; at 64 capacity factor 1.25 drops.
MOE_CASES = {
    "dense_f32": ((1, 8), 16, "float32", 8.0, "direct", 1, ("model",), 2),
    "dense_bf16": ((1, 8), 16, "bfloat16", 8.0, "direct", 1, ("model",), 2),
    "hierarchical_dense": ((2, 4), 16, "float32", 8.0, "hierarchical", 1, ("data", "model"), 2),
    "direct_cf1.25": ((1, 8), 64, "float32", 1.25, "direct", 1, ("model",), 2),
    "chunked_cf1.25": ((1, 8), 64, "float32", 1.25, "chunked", 2, ("model",), 2),
    "hierarchical_cf1.25": ((2, 4), 64, "float32", 1.25, "hierarchical", 1, ("data", "model"),
                            2),
    # what tp_adapt gives on the reference's default 8-device mesh (tp 2) and
    # on a data-only mesh (tp 1): ep_shards 1, an expert axis of 2 or 1
    "refused_4x2": ((4, 2), 16, "float32", 8.0, "direct", 1, ("model",), 1),
    "refused_8x1": ((8, 1), 16, "float32", 8.0, "direct", 1, ("model",), 1),
}
MOE_SEQS = (16, 64)
# the sharded train step through the expert layer: 4 experts on "model" of
# (2, 4) (ep_shards 1), two steps on (2, 8, MOE_TRAIN_SEQ) tokens
MOE_TRAIN_MESH, MOE_TRAIN_SEQ = (2, 4), 32

TRAIN_ARCH = "llama3.2-1b"
TRAIN_MESH = (2, 4)
# name -> (arch, dtype, batch, microbatches, mesh, config changes).  The data
# axes (2) divide 8, not 3.  gemma2: softcap, LOCAL layers, post-norms, the
# gelu MLP; olmo: 4 KV heads that split, the non-parametric LN.  12 query
# heads over 6 KV heads on a model axis of 4: neither divides the other, so
# wk and wv stay whole beside the rank's 3 query heads, which read 2 of the
# groups.  On (1, 8) the 4 heads do not split: attention computes whole
# beside the split MLP and vocabulary.  llama-vision: its XATTN layers'
# cross-attention on the rank's head beside whole KV heads (2 over 4);
# whisper: the encoder, and the decoder's cross-attention on the rank's
# head and KV head; rwkv: 8 heads of 16 over 4, the time-mix and
# channel-mix split; its smoke config's 2 heads of 64 do not divide 4, so
# that layer computes whole; griffin: recurrentgemma's RG-LRU block on the
# rank's 32 of 128 channels, 2 of its 8 gate blocks (on (1, 8): 16
# channels, 1 block, attention's 4 heads whole).
TRAIN_CASES = {
    "f32": (TRAIN_ARCH, "float32", 8, 1, TRAIN_MESH, ()),
    "f32_microbatches": (TRAIN_ARCH, "float32", 8, 2, TRAIN_MESH, ()),
    "f32_batch_3": (TRAIN_ARCH, "float32", 3, 1, TRAIN_MESH, ()),
    "bf16": (TRAIN_ARCH, "bfloat16", 8, 1, TRAIN_MESH, ()),
    "f32_mesh_1x8": (TRAIN_ARCH, "float32", 8, 1, (1, 8), ()),
    "f32_heads_12_over_6": (TRAIN_ARCH, "float32", 8, 1, TRAIN_MESH,
                            (("n_heads", 12), ("n_kv_heads", 6))),
    "gemma2_f32": ("gemma2-9b", "float32", 8, 1, TRAIN_MESH, ()),
    "olmo_f32": ("olmo-1b", "float32", 8, 1, TRAIN_MESH, ()),
    "vision_f32": ("llama-3.2-vision-11b", "float32", 8, 1, TRAIN_MESH, ()),
    "whisper_f32": ("whisper-small", "float32", 8, 1, TRAIN_MESH, ()),
    "rwkv_f32": ("rwkv6-1.6b", "float32", 8, 1, TRAIN_MESH, (("rwkv_head_dim", 16),)),
    "rwkv_heads_whole": ("rwkv6-1.6b", "float32", 8, 1, TRAIN_MESH, ()),
    "griffin_f32": ("recurrentgemma-9b", "float32", 8, 1, TRAIN_MESH, ()),
    "griffin_f32_1x8": ("recurrentgemma-9b", "float32", 8, 1, (1, 8), ()),
}
TRAIN_SEQ = 32
# f32 bound of the blocks after the two steps, of a leaf's largest magnitude.
# RWKV's f32 gradients round apart between two programs by up to 7.6e-6 of
# a leaf's largest magnitude (the port's whole step against the
# reference's, both on the host), and the second Adam step divides each
# element by its own size: a zero-initialised leaf (the LayerNorm biases)
# whose element had a small first gradient then moves apart by up to
# 1.96e-4 of its largest magnitude (the sharded step against the
# reference's; 1.34e-4 where the layer computes whole, 1.06e-4 against the
# port's own single-device step), and by 4.48e-4 a world on an H100
# against a world on the host.  The metrics keep 1e-4.
F32_TOL = 1e-4
RWKV_F32_TOL = 1e-3


def block_tol(case: str) -> float:
    """The f32 bound of a train case's blocks (see ``RWKV_F32_TOL``)."""
    return RWKV_F32_TOL if TRAIN_CASES[case][0] == "rwkv6-1.6b" else F32_TOL


def moe_config(case: str):
    from repro_torch.configs import smoke_config

    _, _, dtype, cf, *_ = MOE_CASES[case]
    return dataclasses.replace(smoke_config(MOE_ARCH), dtype=dtype, capacity_factor=cf)


def moe_train_run():
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig

    cfg = dataclasses.replace(smoke_config(MOE_ARCH), dtype="float32", capacity_factor=8.0)
    return RunConfig(model=cfg, seq_len=MOE_TRAIN_SEQ, global_batch=8, n_microbatches=1,
                     remat=False, warmup_steps=1, total_steps=10, learning_rate=1e-3)


def train_config(case: str):
    from repro_torch.configs import smoke_config

    arch, dtype, *_, changes = TRAIN_CASES[case]
    return dataclasses.replace(smoke_config(arch), dtype=dtype, **dict(changes))


def train_run(case: str):
    from repro_torch.configs.base import RunConfig

    _, _, batch, micro, _, _ = TRAIN_CASES[case]
    return RunConfig(model=train_config(case), seq_len=TRAIN_SEQ, global_batch=batch,
                     n_microbatches=micro, remat=False, warmup_steps=1, total_steps=10,
                     learning_rate=1e-3)


def moe_inputs(seed: int = 0) -> dict:
    """The port's own draw of the MoE checks' inputs (the card's run; the
    tests take the JAX package's): weights in both dtypes from one seed (the
    bf16 tree is the f32 draw rounded, as both packages' ``dense_init``
    makes it) and the tokens."""
    from repro_torch.models.transformer import init_params

    params = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(moe_config("dense_f32"), dtype=dtype)
        params[dtype] = init_params(cfg, torch.Generator().manual_seed(seed), ep_shards=2)
    rng = np.random.default_rng(seed)
    vocab = moe_config("dense_f32").vocab_size
    tokens = {S: torch.from_numpy(rng.integers(0, vocab, (MOE_BATCH, S)).astype(np.int32))
              for S in MOE_SEQS}
    train = init_params(moe_train_run().model, torch.Generator().manual_seed(seed))
    train_tokens = rng.integers(0, vocab, (2, 8, MOE_TRAIN_SEQ)).astype(np.int32)
    return {"params": params, "tokens": tokens, "train_params": train,
            "train_tokens": torch.from_numpy(train_tokens)}


def train_frontends(seed: int = 0) -> dict:
    """Each case's frontend where its model has one: (2, 8, T, width) f32,
    standard normal from ``seed`` as ``SyntheticLM`` draws it, one batch a
    step."""
    rng = np.random.default_rng(seed)
    out = {}
    for case in TRAIN_CASES:
        cfg = train_config(case)
        if cfg.frontend_tokens:
            shape = (2, 8, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
            out[case] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return out


def train_inputs(seed: int = 0) -> dict:
    """The port's draw of the train checks' inputs: each case's weights (the
    XATTN gates drawn non-zero: at zero the layer adds nothing), two
    (8, TRAIN_SEQ) token batches (the 3-row case takes their first 3 rows)
    and the frontends (:func:`train_frontends`)."""
    from repro_torch.models.convert import draw_xattn_gates
    from repro_torch.models.transformer import init_params

    params = {c: init_params(train_config(c), torch.Generator().manual_seed(seed))
              for c in TRAIN_CASES}
    for tree in params.values():
        draw_xattn_gates(tree, np.random.default_rng(seed), leaf=torch.from_numpy)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, train_config("f32").vocab_size, (2, 8, TRAIN_SEQ)).astype(np.int32)
    return {"params": params, "tokens": torch.from_numpy(tokens),
            "frontends": train_frontends(seed)}


def _expert_blocks(params: dict, mesh, ep_axes, device) -> dict:
    """The tree on ``device`` with each MoE layer's experts cut to this rank's
    virtual expert (its block over ``ep_axes``); every other leaf whole."""
    from repro_torch.sharding.specs import P, Sharding, map_with_path

    entry = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    sh = Sharding(mesh, P(None, entry, None, None))

    def one(path, leaf):
        leaf = leaf.to(device)
        return sh.shard(leaf) if path.endswith(("moe/w_in", "moe/w_out")) else leaf

    return map_with_path(one, params)


def moe_program(device: torch.device, inputs: dict,
                cases: Optional[list] = None) -> Dict[str, dict]:
    """Every case of ``MOE_CASES`` (or ``cases``): this rank's slot of the
    logits and the aux loss, or the error a refused layout raised; then,
    under ``"train"``, two sharded train steps through the expert layer
    (:func:`moe_train_program`)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import DistContext, batch_slot, forward

    out = {}
    for case in cases or MOE_CASES:
        dims, S, dtype, _, strategy, chunks, ep_axes, ep_shards = MOE_CASES[case]
        tokens = inputs["tokens"][S].to(device)
        mesh = make_mesh(dims, ("data", "model"), device.type)
        dist = DistContext(mesh=mesh, dp_axes=("data",), ep_shards=ep_shards,
                           moe_strategy=strategy, a2a_chunks=chunks, ep_axes=ep_axes)
        try:
            params = _expert_blocks(inputs["params"][dtype], mesh, ep_axes, device)
            with torch.no_grad():
                logits, aux = forward(moe_config(case), params, batch_slot(dist, tokens),
                                      dist=dist)
        except ValueError as e:
            out[case] = {"error": str(e)}
            continue
        out[case] = {"logits": logits.float(), "aux": aux.float()}
    out["train"] = moe_train_program(device, inputs)
    return out


def moe_train_program(device: torch.device, inputs: dict) -> dict:
    """Two sharded ``train_step``s of smoke dbrx (f32, capacity factor 8) on
    ``MOE_TRAIN_MESH`` with the experts over "model": gradients flow
    through the all-to-alls, the all-gather and the router.  This rank's
    blocks of the parameters and moments, and each step's metrics."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import tree_map, tree_map2
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import DistContext, batch_slot, param_shapes
    from repro_torch.optim import init_state
    from repro_torch.sharding.specs import param_shardings

    run = moe_train_run()
    mesh = make_mesh(MOE_TRAIN_MESH, ("data", "model"), device.type)
    dist = DistContext(mesh=mesh, dp_axes=("data",))
    sh = param_shardings(param_shapes(run.model), mesh)
    blocks = tree_map2(lambda s, t: s.shard(t.to(device)), sh, inputs["train_params"])
    opt = init_state(blocks)
    metrics = []
    for toks in inputs["train_tokens"]:
        blocks, opt, m = train_step(run.model, run, blocks, opt,
                                    {"tokens": batch_slot(dist, toks.to(device))},
                                    dist=dist, shardings=sh)
        metrics.append({k: float(v) for k, v in m.items()})
    host = lambda t: t.detach().float().cpu()  # noqa: E731
    return {"params": tree_map(host, blocks), "mu": tree_map(host, opt.mu),
            "nu": tree_map(host, opt.nu), "metrics": metrics}


def observed(fn, *args, **kw) -> tuple:
    """(``fn``'s result, the collectives it made through ``comms.routes``:
    (operation, bytes read, the global ranks it spans) each, in order)."""
    from repro_torch.comms import routes

    seen = []
    routes.observer = lambda op, b_in, b_out, ranks: seen.append((op, b_in, tuple(ranks)))
    try:
        return fn(*args, **kw), seen
    finally:
        routes.observer = None


def train_program(device: torch.device, inputs: dict,
                  cases: Optional[list] = None) -> Dict[str, dict]:
    """Sharded ``train_step``s, one a batch of the inputs' tokens (steps, 8,
    TRAIN_SEQ) and, where the case has one, of its frontends, a case of
    ``TRAIN_CASES`` (or ``cases``) on its mesh from the inputs' weights:
    this rank's blocks of the new parameters and
    moments, the step count and each step's metrics; the collectives of the
    first step (``"step_collectives"``) and of a forward pass on the
    step's compute tensors (``"forward_collectives"``), and the ranks of
    this rank's model group."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import tree_map, tree_map2
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import DistContext, batch_slot, forward, param_shapes
    from repro_torch.optim import init_state
    from repro_torch.sharding.specs import compute_shardings, param_shardings

    meshes = {}
    out = {}
    for case in cases or TRAIN_CASES:
        _, _, batch, _, dims, _ = TRAIN_CASES[case]
        if dims not in meshes:
            meshes[dims] = make_mesh(dims, ("data", "model"), device.type)
        mesh = meshes[dims]
        dist = DistContext(mesh=mesh, dp_axes=("data",))
        cfg = train_config(case)
        sh = param_shardings(param_shapes(cfg), mesh)
        blocks = tree_map2(lambda s, t: s.shard(t.to(device)), sh, inputs["params"][case])
        opt = init_state(blocks)
        metrics, seen = [], None
        fronts = inputs.get("frontends", {}).get(case)
        for i, toks in enumerate(inputs["tokens"][:, :batch]):
            batch_in = {"tokens": batch_slot(dist, toks.to(device))}
            if fronts is not None:
                batch_in["frontend"] = batch_slot(dist, fronts[i, :batch].to(device))
            (blocks, opt, m), got = observed(train_step, cfg, train_run(case), blocks, opt,
                                             batch_in, dist=dist, shardings=sh)
            seen = got if seen is None else seen
            metrics.append({k: float(v) for k, v in m.items()})
        plan = compute_shardings(sh, gated=cfg.gated)
        with torch.no_grad():
            whole = tree_map2(lambda c, t: c.to_compute(t), plan, blocks)
            _, fwd = observed(forward, cfg, whole, batch_in["tokens"],
                              frontend=batch_in.get("frontend"), dist=dist)
        host = lambda t: t.detach().float().cpu()  # noqa: E731
        out[case] = {"params": tree_map(host, blocks), "mu": tree_map(host, opt.mu),
                     "nu": tree_map(host, opt.nu), "step": int(opt.step), "metrics": metrics,
                     "step_collectives": seen, "forward_collectives": fwd,
                     "model_ranks": tuple(torch.distributed.get_process_group_ranks(
                         mesh.get_group("model")))}
    return out



def ranks_program(device: torch.device, moe_inputs: dict, train_inputs: dict,
                  cases: Optional[list] = None) -> Dict[str, dict]:
    """:func:`moe_program`, then :func:`train_program` of ``cases``, in one
    world (each world's start costs its ranks' imports and device set-up)."""
    return {"moe": moe_program(device, moe_inputs),
            "train": train_program(device, train_inputs, cases)}


def train_world_reports(device: torch.device, legs: list) -> list:
    """:func:`train_world_report` of each (cfg, run_cfg, mesh_shape,
    ep_shards, kw) of ``legs`` in turn, in one world."""
    out = []
    for leg in legs:
        out.append(train_world_report(device, *leg))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def train_world_report(device: torch.device, cfg, run_cfg, mesh_shape: str, ep_shards: int,
                       kw: dict) -> dict:
    """``launch.train.world_run`` under a tracer: the losses and step walls
    it returns, the seconds of each ``train.*`` and ``tp.*`` span in order,
    the calls and bytes of each kind of collective over the run (a
    collective over this rank's model group ``model_<op>``: the split
    compute's all-reduces, RWKV's channel-mix reduce-scatters and
    all-gathers, the gathers of leaves stored split over "model" but
    computed whole; the FSDP gathers ``all_gather``, the gated MLP's
    exchange ``send_recv``, the other ``all_reduce``s: the gradient reduce,
    the norm; an all-gather's bytes those it writes, any other's those it
    reads), and the rank's peak device memory (0 on the CPU)."""
    from repro_torch.comms import routes
    from repro_torch.launch import train
    from repro_torch.obs import trace

    from repro_torch.launch.mesh import mesh_dims

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    m = mesh_dims(mesh_shape, world)[0][-1]  # "model" is the mesh's last axis
    model = tuple(range(rank - rank % m, rank - rank % m + m)) if 1 < m < world else ()
    calls, nbytes = collections.Counter(), collections.Counter()

    def seen(op, b_in, b_out, ranks):
        kind = f"model_{op}" if tuple(ranks) == model else op
        calls[kind] += 1
        nbytes[kind] += b_out if op == "all_gather" else b_in

    tracer = trace.start(name="train")
    routes.observer = seen
    try:
        losses, walls = train.world_run(device, cfg, run_cfg, mesh_shape, ep_shards, kw)
    finally:
        routes.observer = None
        trace.stop()
    spans = [(e["name"], e["dur"] * 1e-6) for e in tracer.events
             if e.get("ph") == "X" and e.get("pid") == 0]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"losses": losses, "walls": walls, "spans": spans, "peak_bytes": peak,
            "collective_calls": dict(calls), "collective_bytes": dict(nbytes)}


def ranks_world_reports(device: torch.device, legs: list, decode: tuple) -> dict:
    """:func:`train_world_reports` of ``legs``, then :func:`long_decode_report`
    of ``decode`` (its arguments after the device), in one world."""
    train = train_world_reports(device, legs)
    return {"train": train, "decode": long_decode_report(device, *decode)}


# -- the serving decode at batch 1 over a world --------------------------------

def long_decode_inputs(cfg, capacity: int, written: int, seed: int, device) -> tuple:
    """(weights, caches, first token (1, 1) int32) drawn on ``device`` from
    ``seed``, alike in every process: the weights as ``init_params`` draws
    them, the caches of batch 1 and ``capacity`` with random K/V and
    positions 0 .. written-1 written (a ring, of the window's capacity, holds
    the last of them at slot pos % capacity), -1 in every other slot."""
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import init_params

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen)
    caches = dec.init_caches(cfg, 1, capacity, device=device)

    def fill(tree):
        if "pos" in tree:
            cap = tree["pos"].shape[-1]
            p = torch.arange(max(written - cap, 0), written, dtype=torch.int32, device=device)
            tree["pos"][..., p % cap] = p
            for key in ("k", "v"):
                tree[key].normal_(generator=gen)
        else:
            for v in tree.values():
                if isinstance(v, dict):
                    fill(v)

    for group in caches:
        for kind in group:
            fill(kind)
    token = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen, device=device,
                          dtype=torch.int32)
    return params, caches, token


def long_decode_single(cfg, capacity: int, written: int, steps: int, seed: int,
                       device) -> dict:
    """``decode_step`` on one device from :func:`long_decode_inputs`: each
    step's logits (1, V) and greedy token, on the host, and its wall (the
    device synchronised)."""
    import time

    from repro_torch.models import decode as dec

    params, caches, token = long_decode_inputs(cfg, capacity, written, seed, device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    logits_, tokens, walls = [], [], []
    with torch.no_grad():
        for i in range(steps):
            pos = torch.tensor(written + i, dtype=torch.int32, device=device)
            sync()
            t0 = time.perf_counter()
            logits, caches = dec.decode_step(cfg, params, caches, token, pos)
            sync()
            walls.append(time.perf_counter() - t0)
            token = logits.argmax(-1, keepdim=True).to(torch.int32)
            logits_.append(logits.cpu())
            tokens.append(int(token))
    return {"logits": torch.cat(logits_).numpy(), "tokens": tokens, "walls": walls}


def long_decode_report(device: torch.device, cfg, mesh_shape: str, capacity: int,
                       written: int, steps: int, seed: int) -> dict:
    """This rank's run of the dry-run's serving decode at batch 1
    (``launch.dryrun.serving_steps``, which computes on the weights' FSDP
    blocks and the KV caches' sequence chunks over "data") from
    :func:`long_decode_inputs`' weights and caches cut to its blocks: each
    step's logits block (1, V/m) and greedy token, each step's wall (the
    device synchronised), the calls and bytes of each kind of collective
    over the steps (``data_<op>`` over the rank's data group, ``model_<op>``
    over its model group; an all-gather's bytes those it writes, any
    other's those it reads), the bytes of its cache blocks and its peak
    device memory over the steps (0 on the CPU)."""
    import time

    from repro_torch.comms import routes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, mesh_dims
    from repro_torch.models import decode as dec
    from repro_torch.models.convert import tree_leaves, tree_map2
    from repro_torch.models.transformer import DistContext, param_shapes
    from repro_torch.sharding.specs import cache_shardings, param_shardings

    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    dims, names = mesh_dims(mesh_shape, world)
    mesh = make_mesh(dims, names, device.type)
    dist = DistContext(mesh=mesh, dp_axes=("data",))
    p_sh = param_shardings(param_shapes(cfg), mesh)
    c_sh = cache_shardings(dec.init_caches(cfg, 1, capacity, device="meta"), mesh,
                           dp_axes=("data",))
    whole = long_decode_inputs(cfg, capacity, written, seed, device)
    params = tree_map2(lambda s, t: s.shard(t), p_sh, whole[0])
    caches = tree_map2(lambda s, t: s.shard(t), c_sh, whole[1])
    token = whole[2]
    del whole
    _, decode = dryrun.serving_steps(cfg, dist, p_sh, c_sh, capacity, 1)
    groups = {f"{a}_": tuple(torch.distributed.get_process_group_ranks(mesh.get_group(a)))
              for a in ("data", "model")}
    calls, nbytes = collections.Counter(), collections.Counter()

    def seen(op, b_in, b_out, ranks):
        kind = next((k for k, g in groups.items() if tuple(ranks) == g), "") + op
        calls[kind] += 1
        nbytes[kind] += b_out if op == "all_gather" else b_in

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    logits_, tokens, walls = [], [], []
    routes.observer = seen
    try:
        for i in range(steps):
            pos = torch.tensor(written + i, dtype=torch.int32, device=device)
            sync()
            t0 = time.perf_counter()
            tok, logits, caches = decode(params, caches, token, pos)
            sync()
            walls.append(time.perf_counter() - t0)
            token = tok[:, None].to(torch.int32)
            logits_.append(logits.cpu())
            tokens.append(int(tok))
    finally:
        routes.observer = None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"logits": torch.cat(logits_).numpy(), "tokens": tokens, "walls": walls,
            "collective_calls": dict(calls), "collective_bytes": dict(nbytes),
            "cache_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(caches)),
            "peak_bytes": peak, "coord": (rank // dims[-1], rank % dims[-1])}


# -- a world on the card against a world on the host --------------------------

# f32 products and sums in another order; bf16: the reference's own bound
CARD_TOL = {"float32": 1e-4, "bfloat16": 0.08}
# the two sharded steps through the expert layer: their blocks move by up to
# 1.04e-3 of a leaf's largest magnitude when the weights move by 1e-6 (a
# host world against itself: Adam's second step turns the router's and rare
# tokens' small gradients into steps of lr), and the card's f32 products
# round apart from the host's by about that much; llama's blocks move by
# 1.5e-5 to 4.5e-5 there and keep 1e-4
EP_TRAIN_TOL = 2e-3
TRAIN_BF16 = (0.15, 2e-2)  # the reference's parameter and loss bounds


def _leaf_gap(a, b) -> float:
    """|a - b| over b's largest magnitude, the largest element."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _blocks_gap(c: dict, h: dict) -> float:
    from repro_torch.models.convert import tree_leaves

    return max(_leaf_gap(x, y) for k in ("params", "mu", "nu")
               for x, y in zip(tree_leaves(c[k]), tree_leaves(h[k])))


def _loss_gap(c: dict, h: dict) -> float:
    return max(abs(a["loss"] - b["loss"]) for a, b in zip(c["metrics"], h["metrics"]))


def compare_moe(card: list, host: list) -> tuple:
    """(the largest gap of each case, the disagreements) between two
    worlds' :func:`moe_program` outputs: logits and aux loss at
    ``CARD_TOL``, the refused layouts' messages equal, and the train
    steps' blocks at ``EP_TRAIN_TOL`` and loss at 1e-4."""
    worst, bad = {}, []
    for r, (c_rank, h_rank) in enumerate(zip(card, host)):
        for case, spec in MOE_CASES.items():
            c, h = c_rank[case], h_rank[case]
            if "error" in c or "error" in h:
                if c.get("error") != h.get("error") or not c.get("error"):
                    bad.append(f"{case} rank {r}: card {c} host {h}")
                continue
            err = max(float(np.abs(c["logits"] - h["logits"]).max()),
                      float(np.abs(c["aux"] - h["aux"]).max()))
            worst[case] = max(worst.get(case, 0.0), err)
            if not err <= CARD_TOL[spec[2]]:
                bad.append(f"{case} rank {r}: {err:.3e} (tol {CARD_TOL[spec[2]]})")
        c, h = c_rank["train"], h_rank["train"]
        gap, loss = _blocks_gap(c, h), _loss_gap(c, h)
        worst["train"] = max(worst.get("train", 0.0), gap)
        if not (gap <= EP_TRAIN_TOL and loss <= 1e-4 * max(abs(h["metrics"][0]["loss"]), 1)):
            bad.append(f"train rank {r}: blocks {gap:.3e} (tol {EP_TRAIN_TOL}), loss {loss}")
    return worst, bad


def compare_train(card: list, host: list) -> tuple:
    """(the largest block gap of each case, the disagreements) between two
    worlds' :func:`train_program` outputs (of the cases they ran): f32
    blocks at :func:`block_tol` of each leaf's largest magnitude and losses
    at 1e-4; bf16 at the reference's bounds."""
    from repro_torch.models.convert import tree_leaves

    worst, bad = {}, []
    for r, (c_rank, h_rank) in enumerate(zip(card, host)):
        for case in c_rank:
            dtype = TRAIN_CASES[case][1]
            c, h = c_rank[case], h_rank[case]
            gap, loss = _blocks_gap(c, h), _loss_gap(c, h)
            worst[case] = max(worst.get(case, 0.0), gap)
            if dtype == "float32":
                ok = gap <= block_tol(case) and loss <= F32_TOL * max(
                    abs(h["metrics"][0]["loss"]), 1)
            else:
                ok = loss < TRAIN_BF16[1] and all(
                    float(np.abs(x - y).max()) < TRAIN_BF16[0]
                    for x, y in zip(tree_leaves(c["params"]), tree_leaves(h["params"])))
            if not ok or c["step"] != h["step"]:
                bad.append(f"{case} rank {r}: blocks {gap:.3e}, loss {loss}")
    return worst, bad

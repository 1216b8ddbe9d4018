"""One rank's program for ``tests/test_torch_tp.py``: the operators of
``repro_torch.sharding.tp``, cross-attention, RWKV's time-mix and
channel-mix and the RG-LRU block on the rank's blocks, the RG-LRU's gates
across ranks, and the dry-run's serving steps (at batch 4, and at batch 1,
whose decode computes on the FSDP blocks and the caches' sequence chunks)
on a world of 4 gloo ranks, meshes (1, 4) and (2, 2).  Imports no JAX (the
ranks are spawned processes)."""
import numpy as np
import torch

WORLD = 4
MESHES = ((1, 4), (2, 2))
# the serving cases: (arch, mesh); smoke width, f32, tp_adapt's config
SERVE_CASES = {"llama_1x4": ("llama3.2-1b", (1, 4)), "llama_2x2": ("llama3.2-1b", (2, 2)),
               "gemma2_2x2": ("gemma2-9b", (2, 2)),
               "vision_1x4": ("llama-3.2-vision-11b", (1, 4)),
               "rwkv_2x2": ("rwkv6-1.6b", (2, 2)),
               "griffin_2x2": ("recurrentgemma-9b", (2, 2)),
               "gemma2_b1_2x2": ("gemma2-9b", (2, 2)),
               "griffin_b1_2x2": ("recurrentgemma-9b", (2, 2)),
               "rwkv_b1_2x2": ("rwkv6-1.6b", (2, 2))}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8, 3
# the batch-1 cases: the batch does not split over "data", so the caches'
# sequence does (``cache_shardings``) and decode computes on the weights'
# FSDP blocks and the K/V's sequence chunks (``dryrun.serving_steps``).  A
# prompt of 30, 4 steps, capacity 64: gemma2's global cache splits at 32, so
# decode writes land in both chunks, and the smoke LOCAL ring of 32 (two
# chunks of 16) wraps at step 2; rwkv6 has no KV cache and holds the
# products on FSDP blocks alone
B1_CASES = ("gemma2_b1_2x2", "griffin_b1_2x2", "rwkv_b1_2x2")
B1_PROMPT, B1_STEPS, B1_CAPACITY = 30, 4, 64
# rwkv6 at 8 heads of 16, so that its heads split over a model axis of 4
# (the sharded train step's rwkv_f32 case); its smoke config has 2 of 64
RWKV_CHANGES = {"rwkv_head_dim": 16}
# the layers on blocks: name -> (arch, the layer); llama-vision's 4 heads
# read 2 KV heads (whole beside the rank's heads on (1, 4), split on
# (2, 2)), whisper's 4 heads 4 (split on both); the RG-LRU's 128 channels in
# 8 gate blocks, 2 blocks a rank on (1, 4), 4 on (2, 2)
LAYER_CASES = {"xattn_vision": ("llama-3.2-vision-11b", "xattn"),
               "xattn_whisper": ("whisper-small", "xattn"),
               "time_mix": ("rwkv6-1.6b", "tm_cm"), "channel_mix": ("rwkv6-1.6b", "tm_cm"),
               "rglru": ("recurrentgemma-9b", "rec")}
LAYER_BATCH, LAYER_SEQ = 2, 5
# the RG-LRU's gates across ranks at a block count of 2 and a width of 16:
# on (1, 4) each block spans 2 ranks (4 of its 8 columns a rank), on (2, 2)
# each rank holds one block
CROSS_BLOCKS, CROSS_WIDTH = 2, 16


def _config(arch: str):
    import dataclasses

    from repro_torch.configs import smoke_config

    changes = RWKV_CHANGES if arch == "rwkv6-1.6b" else {}
    return dataclasses.replace(smoke_config(arch), dtype="float32", **changes)


def serve_shape(case: str):
    """(batch, prompt length, decode steps, cache capacity) of a serving case."""
    if case in B1_CASES:
        return 1, B1_PROMPT, B1_STEPS, B1_CAPACITY
    return SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_PROMPT + SERVE_STEPS


def prompts(inputs: dict, case: str):
    """The case's prompts (batch, prompt length) of the inputs."""
    return inputs["prompts_b1"] if case in B1_CASES else inputs["prompts"]


def serve_config(case: str):
    from repro_torch.sharding.specs import tp_adapt

    arch, dims = SERVE_CASES[case]
    return tp_adapt(_config(arch), dims[1])[0]


def layer_config(case: str):
    return _config(LAYER_CASES[case][0])


def layer_apply(case: str, cfg, p: dict, x, enc, dist):
    """The case's layer on ``p`` (whole, or this rank's blocks with ``dist``)."""
    from repro_torch.models import attention, griffin, rwkv

    if case.startswith("xattn"):
        return attention.cross_attention(cfg, p, x, attention.cross_kv(cfg, p, enc, dist), dist)
    if case == "rglru":
        return griffin.rglru_block(cfg, p, x, dist)
    if case == "time_mix":
        return rwkv.rwkv_time_mix(cfg, p, x, dist=dist)
    return rwkv.rwkv_channel_mix(cfg, p, x, dist)


def layer_split(case: str, cfg, p: dict, dist) -> bool:
    """The layer's own test of ``p``: its rank's blocks (True) or whole."""
    from repro_torch.models import griffin, rwkv

    return (griffin if case == "rglru" else rwkv).tp_split(cfg, p, dist)


def layer_blocks(case: str, p: dict, model: int, rank: int) -> dict:
    """(``p`` with the leaves that a split layer holds as blocks cut to
    model rank ``rank``'s of ``model``, whether each leaf was cut)."""
    from repro_torch.sharding import specs

    key = LAYER_CASES[case][1]
    plan = specs.compute_shardings(
        specs.param_shardings({key: p}, {"model": model}, fsdp=False), gated=False)[key]
    cut = {k: plan[k].gather != plan[k].storage for k in p}
    return ({k: plan[k].storage.block(t, {"model": rank}) if cut[k] else t
             for k, t in p.items()}, cut)


def _ops(device, inputs, mesh) -> dict:
    """The vocabulary operators and the gated exchange on this rank's
    blocks of the inputs' whole tensors."""
    from repro_torch.launch.mesh import axes_index
    from repro_torch.models.transformer import DistContext
    from repro_torch.sharding import tp

    dist = DistContext(mesh=mesh, dp_axes=("data",))
    r, n = axes_index(mesh, ("model",)), mesh.shape[1]
    block = lambda t: t.chunk(n, dim=-1)[r].contiguous().to(device)  # noqa: E731
    out = {}
    logits = block(inputs["logits"]).requires_grad_()
    nll = tp.vocab_nll(logits, inputs["labels"].to(device), inputs["logits"].shape[-1], dist)
    (grad,) = torch.autograd.grad(nll.sum(), logits)
    out["nll"], out["nll_grad"] = nll.detach(), grad
    out["argmax"] = tp.vocab_argmax(block(inputs["tied"]), inputs["tied"].shape[-1], dist)
    table = inputs["table"].chunk(n, dim=0)[r].contiguous().to(device).requires_grad_()
    x = tp.vocab_embed(table, inputs["ids"].to(device), inputs["table"].shape[0], dist)
    (g_table,) = torch.autograd.grad((x * inputs["embed_weight"].to(device)).sum(), table)
    out["embed"], out["embed_grad"] = x.detach(), g_table
    storage = block(inputs["w_in"])
    compute = tp.gated_to_compute(storage, mesh)
    out["w_in_compute"] = compute
    out["w_in_back"] = tp.gated_to_storage(compute, mesh)
    return out


def _layers(device, inputs, mesh) -> dict:
    """Each layer of ``LAYER_CASES`` on this rank's blocks: its output and the
    gradients of (output · the inputs' weight) with respect to its input,
    the frontend states (cross-attention) and each leaf (a cut leaf's its
    block)."""
    from repro_torch.launch.mesh import axes_index
    from repro_torch.models.transformer import DistContext

    dist = DistContext(mesh=mesh, dp_axes=("data",))
    r, n = axes_index(mesh, ("model",)), mesh.shape[1]
    out = {}
    for case in LAYER_CASES:
        cfg = layer_config(case)
        whole = {k: t.to(device) for k, t in inputs["layers"][case].items()}
        p, _ = layer_blocks(case, whole, n, r)
        p = {k: t.detach().clone().requires_grad_() for k, t in p.items()}
        x = inputs["layer_x"].to(device).requires_grad_()
        enc = inputs["layer_enc"][case].to(device).requires_grad_()
        y = layer_apply(case, cfg, p, x, enc, dist)
        names = list(p)
        leaves = [x, enc] + [p[k] for k in names] if case.startswith("xattn") else \
            [x] + [p[k] for k in names]
        grads = torch.autograd.grad((y * inputs["layer_w"].to(device)).sum(), leaves,
                                    allow_unused=True, materialize_grads=True)
        keys = ["x", "enc"] + names if case.startswith("xattn") else ["x"] + names
        out[case] = {"out": y.detach(), "grads": dict(zip(keys, grads))}
    return out


def _cross_gates(device, inputs, mesh) -> dict:
    """``griffin._gate_products`` on this rank's channels of the inputs' u
    with the whole gates at ``CROSS_BLOCKS`` blocks: the rank's columns of
    both products, and the gradients of (both · the inputs' weights) with
    respect to its channels of u and to each whole gate."""
    from repro_torch.launch.mesh import axes_index
    from repro_torch.models import griffin
    from repro_torch.models.transformer import DistContext

    dist = DistContext(mesh=mesh, dp_axes=("data",))
    r, n = axes_index(mesh, ("model",)), mesh.shape[1]
    g = inputs["cross"]
    u = g["u"].chunk(n, -1)[r].contiguous().to(device).requires_grad_()
    p = {k: g[k].to(device).requires_grad_() for k in ("gate_a", "gate_x")}
    za, zx = griffin._gate_products(p, u, True, dist, n_blocks=CROSS_BLOCKS)
    w = g["weight"].chunk(n, -1)[r].to(device)
    gu, ga, gx = torch.autograd.grad((za * w[0] + zx * w[1]).sum(), [u, p["gate_a"], p["gate_x"]])
    return {"za": za.detach(), "zx": zx.detach(), "u": gu, "gate_a": ga, "gate_x": gx}


def _serve(device, inputs, case: str, mesh) -> dict:
    """The dry-run's serving steps (``launch.dryrun.serving_steps``) on this
    rank's blocks: prefill, then the case's greedy decode steps, each
    step's next tokens and logits block, and the caches' blocks after
    prefill and at the end; and the collectives of the decode steps
    (operation, bytes written: ``comms.routes.observer``)."""
    from repro_torch.comms import routes
    from repro_torch.launch import dryrun
    from repro_torch.models import decode as dec
    from repro_torch.models.convert import tree_map, tree_map2
    from repro_torch.models.transformer import DistContext, batch_slot, param_shapes
    from repro_torch.sharding import specs

    cfg = serve_config(case)
    batch, prompt, n_steps, cap = serve_shape(case)
    dist = DistContext(mesh=mesh, dp_axes=("data",))
    p_sh = specs.param_shardings(param_shapes(cfg), mesh)
    c_sh = specs.cache_shardings(dec.init_caches(cfg, batch, cap, device="meta"), mesh,
                                 dp_axes=("data",))
    params = tree_map2(lambda s, t: s.shard(t.to(device)), p_sh, inputs["serve_params"][case])
    prefill, decode = dryrun.serving_steps(cfg, dist, p_sh, c_sh, cap, batch)
    tokens = batch_slot(dist, prompts(inputs, case).to(device))
    front = inputs["frontends"].get(case)
    tok, logits, caches = prefill(params, tokens,
                                  None if front is None else batch_slot(dist, front.to(device)))
    # copies: decode writes the caches in place
    host = lambda t: t.detach().cpu().clone()  # noqa: E731
    out = {"tokens": [host(tok)], "logits": [host(logits)],
           "prefill_caches": tree_map(host, caches), "decode_collectives": []}
    routes.observer = lambda op, b_in, b_out, ranks: out["decode_collectives"].append((op, b_out))
    try:
        for i in range(n_steps):
            pos = torch.tensor(prompt + i, dtype=torch.int32, device=device)
            tok, logits, caches = decode(params, caches, tok[:, None].to(torch.int32), pos)
            out["tokens"].append(host(tok))
            out["logits"].append(host(logits))
    finally:
        routes.observer = None
    out["caches"] = tree_map(host, caches)
    return out


def program(device: torch.device, inputs: dict) -> dict:
    from repro_torch.launch.mesh import make_mesh

    meshes = {dims: make_mesh(dims, ("data", "model"), device.type) for dims in MESHES}
    out = {f"ops_{a}x{b}": _ops(device, inputs, meshes[(a, b)]) for a, b in MESHES}
    out.update({f"layers_{a}x{b}": _layers(device, inputs, meshes[(a, b)]) for a, b in MESHES})
    out.update({f"cross_{a}x{b}": _cross_gates(device, inputs, meshes[(a, b)])
                for a, b in MESHES})
    for case, (_, dims) in SERVE_CASES.items():
        out[case] = _serve(device, inputs, case, meshes[dims])
    return out


def inputs(seed: int = 0) -> dict:
    """Whole tensors drawn from ``seed``: logits (with equal maxima across
    blocks in ``tied``), labels, an embedding table and ids, a gated w_in,
    the layers' weights (RWKV's mixes, decay base, bonus and norm scale
    drawn too, not the constants they start from), input, frontend states
    and output weight (the RG-LRU's conv bias and Lambda drawn too), the
    RG-LRU's gates across ranks (u, two gates, the outputs' weights), the
    serving cases' weights (the XATTN gates drawn non-zero), prompts and
    frontends, and last the batch-1 cases' prompt."""
    from repro_torch.models.attention import attn_params
    from repro_torch.models.convert import draw_xattn_gates
    from repro_torch.models.griffin import rglru_params
    from repro_torch.models.rwkv import rwkv_params
    from repro_torch.models.transformer import init_params

    rng = np.random.default_rng(seed)
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    V = 32
    tied = f32(3, V)
    tied[0, 5] = tied[0, 29] = tied[0].abs().max() + 1  # blocks 0 and 3 of 4 tie
    tied[1, 20] = tied[1, 21] = tied[1].abs().max() + 1  # within block 2
    out = {
        "logits": f32(2, 5, V), "labels": torch.from_numpy(rng.integers(0, V, (2, 5))),
        "tied": tied, "table": f32(V, 6), "ids": torch.from_numpy(rng.integers(0, V, (3, 7))),
        "embed_weight": f32(3, 7, 6), "w_in": f32(6, 2 * 16),
        "serve_params": {c: init_params(serve_config(c), torch.Generator().manual_seed(seed))
                         for c in SERVE_CASES},
        "prompts": torch.from_numpy(rng.integers(0, 512, (SERVE_BATCH, SERVE_PROMPT))
                                    .astype(np.int32)),
    }
    layers, enc = {}, {}
    for case, (arch, key) in LAYER_CASES.items():
        cfg = layer_config(case)
        gen = torch.Generator().manual_seed(seed)
        if key == "xattn":
            width = cfg.frontend_dim or cfg.d_model
            layers[case] = attn_params(cfg, gen, kv_input_dim=width)
        elif key == "rec":
            layers[case] = rglru_params(cfg, gen)
            continue  # its draws come last
        else:
            p = rwkv_params(cfg, gen)
            for k in ("mu", "cmu", "u", "ln_scale"):
                p[k] = p[k] + 0.3 * f32(*p[k].shape)
            p["w0"] = p["w0"] + 0.5 * f32(*p["w0"].shape)
            layers[case] = p
        width = cfg.frontend_dim or cfg.d_model
        enc[case] = f32(LAYER_BATCH, max(cfg.frontend_tokens, 1), width)
    frontends = {}
    for c, tree in out["serve_params"].items():
        draw_xattn_gates(tree, rng, leaf=torch.from_numpy)
        cfg = serve_config(c)
        if cfg.frontend_tokens:
            frontends[c] = f32(SERVE_BATCH, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
    d = layer_config("time_mix").d_model
    out.update(layers=layers, layer_enc=enc, layer_x=f32(LAYER_BATCH, LAYER_SEQ, d),
               layer_w=f32(LAYER_BATCH, LAYER_SEQ, d), frontends=frontends)
    rec = layers["rglru"]
    rec["conv_b"] = 0.3 * f32(*rec["conv_b"].shape)
    rec["lam"] = rec["lam"] + 0.5 * f32(*rec["lam"].shape)
    enc["rglru"] = torch.zeros((LAYER_BATCH, 1, d))  # unused
    bw = CROSS_WIDTH // CROSS_BLOCKS
    out["cross"] = {"u": f32(LAYER_BATCH, LAYER_SEQ, CROSS_WIDTH),
                    "gate_a": f32(CROSS_BLOCKS, bw, bw) / bw ** 0.5,
                    "gate_x": f32(CROSS_BLOCKS, bw, bw) / bw ** 0.5,
                    "weight": f32(2, LAYER_BATCH, LAYER_SEQ, CROSS_WIDTH)}
    out["prompts_b1"] = torch.from_numpy(rng.integers(0, 512, (1, B1_PROMPT)).astype(np.int32))
    return out

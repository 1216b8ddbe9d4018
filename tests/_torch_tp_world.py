"""One rank's program for ``tests/test_torch_tp.py``: the operators of
``repro_torch.sharding.tp`` and the dry-run's serving steps on a world of 4
gloo ranks, meshes (1, 4) and (2, 2).  Imports no JAX (the ranks are
spawned processes)."""
import numpy as np
import torch

WORLD = 4
MESHES = ((1, 4), (2, 2))
# the serving cases: (arch, mesh); smoke width, f32, tp_adapt's config
SERVE_CASES = {"llama_1x4": ("llama3.2-1b", (1, 4)), "llama_2x2": ("llama3.2-1b", (2, 2)),
               "gemma2_2x2": ("gemma2-9b", (2, 2))}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8, 3


def serve_config(case: str):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.sharding.specs import tp_adapt

    arch, dims = SERVE_CASES[case]
    return tp_adapt(dataclasses.replace(smoke_config(arch), dtype="float32"), dims[1])[0]


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


def _serve(device, inputs, case: str, mesh) -> dict:
    """The dry-run's serving steps (``launch.dryrun.serving_steps``) on this
    rank's blocks: prefill, then SERVE_STEPS greedy decode steps, each
    step's next tokens and logits block, and the caches' blocks after
    prefill and at the end."""
    from repro_torch.launch import dryrun
    from repro_torch.models import decode as dec
    from repro_torch.models.convert import tree_map, tree_map2
    from repro_torch.models.transformer import DistContext, batch_slot, param_shapes
    from repro_torch.sharding import specs

    cfg = serve_config(case)
    dist = DistContext(mesh=mesh, dp_axes=("data",))
    cap = SERVE_PROMPT + SERVE_STEPS
    p_sh = specs.param_shardings(param_shapes(cfg), mesh)
    c_sh = specs.cache_shardings(dec.init_caches(cfg, SERVE_BATCH, cap, device="meta"), mesh,
                                 dp_axes=("data",))
    params = tree_map2(lambda s, t: s.shard(t.to(device)), p_sh, inputs["serve_params"][case])
    prefill, decode = dryrun.serving_steps(cfg, dist, p_sh, c_sh, cap)
    tokens = batch_slot(dist, inputs["prompts"].to(device))
    tok, logits, caches = prefill(params, tokens)
    # copies: decode writes the caches in place
    host = lambda t: t.detach().cpu().clone()  # noqa: E731
    out = {"tokens": [host(tok)], "logits": [host(logits)],
           "prefill_caches": tree_map(host, caches)}
    for i in range(SERVE_STEPS):
        pos = torch.tensor(SERVE_PROMPT + i, dtype=torch.int32, device=device)
        tok, logits, caches = decode(params, caches, tok[:, None].to(torch.int32), pos)
        out["tokens"].append(host(tok))
        out["logits"].append(host(logits))
    out["caches"] = tree_map(host, caches)
    return out


def program(device: torch.device, inputs: dict) -> dict:
    from repro_torch.launch.mesh import make_mesh

    meshes = {dims: make_mesh(dims, ("data", "model"), device.type) for dims in MESHES}
    out = {f"ops_{a}x{b}": _ops(device, inputs, meshes[(a, b)]) for a, b in MESHES}
    for case, (_, dims) in SERVE_CASES.items():
        out[case] = _serve(device, inputs, case, meshes[dims])
    return out


def inputs(seed: int = 0) -> dict:
    """Whole tensors drawn from ``seed``: logits (with equal maxima across
    blocks in ``tied``), labels, an embedding table and ids, a gated w_in,
    the serving cases' weights and prompts."""
    from repro_torch.models.transformer import init_params

    rng = np.random.default_rng(seed)
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    V = 32
    tied = f32(3, V)
    tied[0, 5] = tied[0, 29] = tied[0].abs().max() + 1  # blocks 0 and 3 of 4 tie
    tied[1, 20] = tied[1, 21] = tied[1].abs().max() + 1  # within block 2
    return {
        "logits": f32(2, 5, V), "labels": torch.from_numpy(rng.integers(0, V, (2, 5))),
        "tied": tied, "table": f32(V, 6), "ids": torch.from_numpy(rng.integers(0, V, (3, 7))),
        "embed_weight": f32(3, 7, 6), "w_in": f32(6, 2 * 16),
        "serve_params": {c: init_params(serve_config(c), torch.Generator().manual_seed(seed))
                         for c in SERVE_CASES},
        "prompts": torch.from_numpy(rng.integers(0, 512, (SERVE_BATCH, SERVE_PROMPT))
                                    .astype(np.int32)),
    }

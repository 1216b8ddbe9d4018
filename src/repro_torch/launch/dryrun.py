"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell, per
rank, on meta tensors in a fake world of 256 or 512 ranks.

The counterpart of ``repro.launch.dryrun``.  For each cell this:
  1. starts a fake ``torch.distributed`` world in this process, as rank 0
     (``torch.testing._internal.distributed.fake_pg``: its collectives move
     nothing), 256 ranks for ``single`` and 512 for ``multi``, and builds
     the production mesh over it — (16,16) "data","model" or (2,16,16)
     "pod","data","model";
  2. adapts the architecture config for the TP width (KV expansion,
     ep_shards — ``sharding.specs.tp_adapt``);
  3. makes this rank's blocks of the params / AdamW moments / caches and its
     slot of the batch on the meta device — nothing is allocated; the
     moments take the FSDP rules on ``--opt-fsdp-axes`` (by default
     ``--fsdp-axes``), under ``--no-fsdp`` too, as the reference's do, and
     ``train_step`` updates them on their own blocks (ZeRO-1 over "pod"
     with ``--opt-fsdp-axes pod+data``);
  4. runs the step (``train_step``, ``prefill_step`` or ``decode_step`` by
     the shape's kind) once, eagerly, under the cost counter
     (``launch.hlo_analysis.trace_cost``), with the kernels off
     (``use_kernels(False)``, as the reference lowers with ``use_pallas``
     off);
  5. records the counter's compute, memory and per-kind collective bytes
     (ICI vs DCN by the pods the group's ranks lie in) into
     ``<out>/<arch>__<shape>__<mesh>__<tag>.json``, under the reference's
     keys, so ``benchmarks/roofline.py::terms`` reads it unchanged.

Two things of the reference have no meaning in eager: it records
``compile_s`` (lower + compile), this records ``trace_s`` (build + the
counted run); and it keeps the compiled HLO (``hlo_chars`` and a
``.hlo.gz`` beside the record), which has no eager counterpart, so neither
is written.

The compute splits over "model" as the reference's GSPMD splits it
(``sharding.tp``): self- and cross-attention on the rank's heads, the dense
MLP on its FF block, RWKV's time-mix on its heads and its channel-mix on
its FF block, the RG-LRU block on its channels (its gates on its columns
of their blocks), the embedding, unembedding and greedy pick on its
vocabulary block.  The serving steps (:func:`serving_steps`) take this
rank's blocks (``param_shardings``, ``cache_shardings``) and gather for
compute (``specs.compute_shardings``): a split leaf over its FSDP axes
only, the self- and cross-attention caches over their sequence dim only
(the batch dim stays the rank's slot and the KV-head dim its heads),
RWKV's state and the RG-LRU's ``h`` and ``conv`` not at all (the rank's
slot, its heads or channels), the MoE weights but for their expert dim
(the rank's virtual experts), and every other leaf whole (RWKV's token
shifts, the RG-LRU's gates where their 8 blocks do not divide the axis).
Where the batch does not split over the data axes (``long_500k``'s batch
of 1, whose caches ``cache_shardings`` splits over "data" on the
sequence), decode also computes over "data" as GSPMD does there: on the
weights' FSDP blocks (a column-parallel product over the rank's block of
channels, a row-parallel one writing its block of the output's) and on
the rank's sequence chunk of each self-attention cache, its softmax
combined over "data" (``DistContext.data_split``).  The steps hand back
the next tokens, the rank's logits block and its blocks of the new caches.
``train_step`` gathers for compute itself.  The gathers are counted as the
all-gathers they are, the gated MLP's exchange as collective-permutes.  In
every cell the per-rank ``dot_flops`` is then the reference's but where
the reference splits what the port computes whole (the weight gradients
of leaves computed whole, as whisper's unsplit heads'), computes whole
what the port splits (rwkv6's ``cm_r`` in training), or computes more on
one mesh than on another (rwkv6's ``long_500k`` on ``multi``; PERF.md,
section 6).  ``hbm_bytes`` is eager's (no fusion), larger than XLA's
post-fusion count.

Usage:
  python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--tag variantname ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import sys
import time
import traceback

from repro_torch.launch.hlo_analysis import trace_cost
from repro_torch.obs import trace as obs_trace

CHIPS_PER_POD = 256
WORLD = {"single": 256, "multi": 512}


def start_world(mesh_kind: str) -> None:
    """A fake world of the mesh kind's size in this process, as rank 0;
    one of another size is destroyed first.  A real world raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = WORLD[mesh_kind]
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("dryrun: a real torch.distributed world is initialised; the "
                               "dry-run starts its own fake one")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def stop_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _unsplit(sharding, dims):
    """``sharding`` with the entries of ``dims`` not split: gathering with it
    leaves those dims as the rank's block."""
    from repro_torch.sharding.specs import PartitionSpec, Sharding

    spec = PartitionSpec(*(None if i in dims else e for i, e in enumerate(sharding.spec)))
    return Sharding(sharding.mesh, spec)


def _compute_shardings(p_sh, c_sh, gated: bool, data_axes=()):
    """(params' ``ComputeSharding``s, caches' gather shardings) of the
    serving steps: ``compute_shardings``, with the MoE weights' expert dim
    (dim 1, under the group's stack) kept as the rank's block; the caches
    keep their batch dim (dim 1), the self- and cross-attention caches their
    KV-head dim (dim 3 of (count, B, capacity, G, dh)), RWKV's state its
    head dim (dim 2 of (count, B, H, K, V)) and the RG-LRU's ``h`` and
    ``conv`` their channels (dim 2 of (count, B, W), dim 3 of (count, B,
    width - 1, W)).  With ``data_axes`` (a decode on the FSDP blocks) the
    params of ``specs.DATA_SPLIT_COMPUTE`` also keep their blocks over those
    axes, and the self-attention caches their sequence chunk (dim 2)."""
    from repro_torch.sharding.specs import compute_shardings, map_with_path

    def param(path, c):
        if path.endswith(("moe/w_in", "moe/w_out")):
            return dataclasses.replace(c, gather=_unsplit(c.storage, {1}))
        return c

    def cache(path, s):
        if data_axes and re.search(r"(^|/)(k|v)$", path):
            return _unsplit(s, {1, 2, 3})
        if re.search(r"(^|/)(k|v|ck|cv|conv)$", path):
            return _unsplit(s, {1, 3})
        if re.search(r"(^|/)(state|h)$", path):
            return _unsplit(s, {1, 2})
        return _unsplit(s, {1})

    return (map_with_path(param, compute_shardings(p_sh, gated=gated, keep_axes=data_axes)),
            map_with_path(cache, c_sh))


# the axis over which ``specs.cache_shardings`` splits a cache's sequence
# where the batch does not split over the data axes, and which a decode
# step then computes over (its ``DistContext.data_split``)
SEQ_AXIS = "data"


def serving_steps(cfg, dist, p_sh, c_sh, capacity: int, batch: int):
    """(prefill(params, tokens[, frontend]), decode(params, caches, token,
    pos)) on this rank's blocks by ``p_sh`` and ``c_sh`` and its slot of
    the global ``batch``, without gradients, each returning (the next tokens
    of its slot, its logits block over the vocabulary, its blocks of the new
    caches).

    Where ``batch`` does not split over the data axes (as the caches'
    sequence then splits over ``SEQ_AXIS``), decode computes on the
    weights' FSDP blocks over that axis and attends over the rank's
    sequence chunk of the self-attention caches, as the reference's GSPMD
    does: its plan keeps those blocks (``DATA_SPLIT_COMPUTE``), its caches'
    chunks are neither gathered nor cut (decode writes them in place), and
    its ``DistContext`` names the axis in ``data_split``.  Prefill keeps
    gathering the weights over the data axes and hands back the caches'
    sequence chunks."""
    import torch

    from repro_torch.models import steps
    from repro_torch.models.convert import tree_map2
    from repro_torch.sharding import tp
    from repro_torch.sharding.specs import mesh_shape

    p_plan, c_whole = _compute_shardings(p_sh, c_sh, cfg.gated)
    data_axes = ()
    if dist.dp_size > 1 and batch % dist.dp_size and mesh_shape(dist.mesh).get(SEQ_AXIS, 1) > 1:
        data_axes = (SEQ_AXIS,)
    d_plan, c_dec = _compute_shardings(p_sh, c_sh, cfg.gated, data_axes)
    d_dist = dataclasses.replace(dist, data_split=data_axes)

    def compute(plan, p):
        return tree_map2(lambda c, t: c.to_compute(t), plan, p)

    def blocks(shardings, tree):
        return tree_map2(lambda s, t: s.block(t), shardings, tree)

    def pick(logits):
        return tp.vocab_argmax(logits, cfg.vocab_padded, dist)

    def prefill(p, t, f=None):
        with torch.no_grad():
            logits, caches = steps.prefill_step(cfg, compute(p_plan, p), t, frontend=f,
                                                capacity=capacity, dist=dist)
            return pick(logits), logits, blocks(c_whole, caches)

    def decode(p, c, t, q):
        with torch.no_grad():
            caches = tree_map2(lambda s, x: s.gather(x), c_dec, c)
            logits, new = steps.decode_step(cfg, compute(d_plan, p), caches, t, q,
                                            dist=d_dist)
            return pick(logits), logits, blocks(c_dec, new)

    return prefill, decode


def build_cell(arch: str, shape_name: str, mesh_kind: str, variant: dict):
    """Returns (step fn, args tuple of this rank's meta blocks, meta dict) for
    one cell; (None, None, meta with "skipped") where the cell is skipped."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import dp_axes_of, make_production_mesh, mesh_axes
    from repro_torch.models import decode as dec
    from repro_torch.models import steps
    from repro_torch.models.common import dtype_of
    from repro_torch.models.convert import tree_map2
    from repro_torch.models.transformer import DistContext, param_shapes
    from repro_torch.sharding import specs

    shape = SHAPES[shape_name]
    start_world(mesh_kind)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
    sizes = mesh_axes(mesh)
    tp = sizes["model"]
    cfg0 = get_config(arch)
    cfg, ep_shards = specs.tp_adapt(cfg0, tp)

    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return None, None, {
            "skipped": "pure full-attention arch: 500k dense-KV decode "
            "excluded per spec (DESIGN.md §Arch-applicability)"
        }

    if variant.get("wkv_chunk"):
        cfg = dataclasses.replace(cfg, wkv_chunk=int(variant["wkv_chunk"]))

    dp_axes = dp_axes_of(mesh)
    ep_axes = ("model",)
    if variant.get("serve_layout"):
        # serving layout: experts spread over (data x model) — no FSDP
        # weight gathers at decode; dispatch a2a spans both axes
        ep_axes = ("data", "model")
        total = math.prod(sizes[a] for a in ep_axes)
        if cfg.is_moe:
            ep_shards = total // cfg.n_experts if total % cfg.n_experts == 0 else ep_shards
        variant = dict(variant, no_fsdp=True)
        if variant.get("moe_strategy", "direct") == "auto" and cfg.is_moe:
            from repro_torch.comms.autotune import select_moe_dispatch_strategy
            from repro_torch.models.moe import capacity as moe_capacity

            toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
            tslice = max(1, -(-toks // total))
            bucket = moe_capacity(cfg, tslice) * cfg.d_model * 2
            variant = dict(variant, moe_strategy=select_moe_dispatch_strategy(
                dict(sizes), ep_axes, float(bucket)))
    dist = DistContext(
        mesh=mesh,
        dp_axes=dp_axes,
        model_axis="model",
        ep_shards=ep_shards,
        moe_strategy=variant.get("moe_strategy", "direct"),
        a2a_chunks=int(variant.get("a2a_chunks", 1)),
        ep_axes=ep_axes,
    )
    fsdp = not variant.get("no_fsdp", False)
    fsdp_axes = tuple(variant.get("fsdp_axes", "data").split("+"))
    remat = not variant.get("no_remat", False)

    p_shape = param_shapes(cfg, ep_shards)
    p_sh = specs.param_shardings(p_shape, mesh, fsdp=fsdp, fsdp_axes=fsdp_axes,
                                 ep_axes=ep_axes)
    params = tree_map2(lambda s, t: s.shard(t), p_sh, p_shape)

    B, S = shape.global_batch, shape.seq_len
    tok_sh = specs.batch_sharding(mesh, B, 2, dp_axes)
    meta = {
        "arch": arch,
        "deploy_kv_heads": cfg.n_kv_heads,
        "ep_shards": ep_shards,
        "ep_axes": list(ep_axes),
        "moe_strategy_resolved": dist.moe_strategy,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }

    def tokens(n_seq: int):
        return tok_sh.shard(torch.empty((B, n_seq), dtype=torch.int32, device="meta"))

    frontend = None
    if cfg.frontend_tokens:
        fd = cfg.frontend_dim or cfg.d_model
        frontend = specs.batch_sharding(mesh, B, 3, dp_axes).shard(
            torch.empty((B, cfg.frontend_tokens, fd), dtype=dtype_of(cfg), device="meta"))

    if shape.kind == "train":
        run = RunConfig(
            model=cfg,
            seq_len=S,
            global_batch=B,
            n_microbatches=int(variant.get("microbatches", 1)),
            fsdp=fsdp,
            remat=remat,
            remat_policy=variant.get("remat_policy", "block"),
            grad_accum_dtype=variant.get("grad_accum_dtype", "float32"),
        )
        # the moments take the FSDP rules on their own axes, under --no-fsdp
        # too, as the reference's (ZeRO-1 with --opt-fsdp-axes pod+data)
        opt_fsdp_axes = tuple(variant.get("opt_fsdp_axes", "+".join(fsdp_axes)).split("+"))
        o_sh = specs.opt_shardings(p_shape, mesh, fsdp=True, fsdp_axes=opt_fsdp_axes,
                                   ep_axes=ep_axes)
        opt = specs.init_opt_blocks(o_sh, p_shape, "meta")
        batch = {"tokens": tokens(S)}
        if frontend is not None:
            batch["frontend"] = frontend

        def fn(p, o, b):
            return steps.train_step(cfg, run, p, o, b, dist=dist, shardings=p_sh,
                                    opt_shardings=o_sh)

        meta["tokens_global"] = B * S
        meta["step_kind"] = "train"
        return fn, (params, opt, batch), meta

    caches_shape = dec.init_caches(cfg, B, S, device="meta")
    c_sh = specs.cache_shardings(caches_shape, mesh, dp_axes=dp_axes)
    prefill, decode = serving_steps(cfg, dist, p_sh, c_sh, S, B)

    if shape.kind == "prefill":
        fn = prefill
        args = (params, tokens(S)) + ((frontend,) if frontend is not None else ())
        meta["tokens_global"] = B * S
        meta["step_kind"] = "prefill"
        return fn, args, meta

    # decode: one new token against a seq_len-deep cache
    caches = tree_map2(lambda s, t: s.shard(t), c_sh, caches_shape)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    meta["tokens_global"] = B
    meta["step_kind"] = "decode"
    return decode, (params, caches, tokens(1), pos), meta


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: dict, outdir: str):
    from repro_torch.kernels.config import kernels_enabled, use_kernels

    tag = variant.get("tag", "baseline")
    cell_id = f"{arch}__{shape_name}__{mesh_kind}__{tag}"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": {k: v for k, v in variant.items() if k != "tag"}, "tag": tag,
    }
    t0 = time.time()
    was_on = kernels_enabled()
    use_kernels(False)
    try:
        with obs_trace.span("dryrun.build", cell=cell_id):
            fn, args, meta = build_cell(arch, shape_name, mesh_kind, variant)
        rec.update(meta)
        if fn is None:
            rec["ok"] = "skipped"
        else:
            with obs_trace.span("dryrun.trace", cell=cell_id):
                counted = trace_cost(fn, *args, chips_per_pod=CHIPS_PER_POD)
            rec["trace_s"] = round(time.time() - t0, 1)
            rec["memory"] = {
                "argument_bytes": counted.argument_bytes,
                "output_bytes": counted.output_bytes,
                "temp_bytes": counted.temp_bytes,
                "alias_bytes": counted.alias_bytes,
                "generated_code_bytes": 0,
            }
            hc = counted.cost
            rec["cost"] = {"flops": counted.flops, "bytes_accessed": hc.hbm_bytes}
            rec["hlo_cost"] = {
                "dot_flops": hc.dot_flops,
                "hbm_bytes": hc.hbm_bytes,
                "collectives": hc.collectives,
                "collective_ici_bytes": hc.collective_ici_total(),
                "collective_dcn_bytes": hc.collective_dcn_total(),
            }
            rec["ok"] = True
    except (ValueError, TypeError, KeyError, AttributeError, RuntimeError,
            NotImplementedError, OSError) as e:
        # record the failure, keep sweeping: shape/sharding mistakes surface
        # as ValueError/TypeError, a host read of a meta tensor or a kernel
        # launch under the counter as RuntimeError, the record as OSError —
        # anything else is a harness bug and should crash loudly
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[dryrun] {cell_id}: failed with {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
    finally:
        use_kernels(was_on)
    rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, cell_id + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec.get("ok")
    print(f"[dryrun] {cell_id}: ok={status} ({rec['total_s']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--moe-strategy", default="direct")
    ap.add_argument("--a2a-chunks", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--fsdp-axes", default="data", help="e.g. pod+data")
    ap.add_argument("--opt-fsdp-axes", default="", help="optimizer-state FSDP axes (ZeRO-1 over pod)")
    ap.add_argument("--grad-accum-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--remat-policy", default="block", choices=["block", "dots", "none"])
    ap.add_argument("--serve-layout", action="store_true")
    ap.add_argument("--wkv-chunk", type=int, default=0)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument(
        "--trace", default="", metavar="PATH",
        help="write a Chrome trace_event JSON of the sweep (build/trace "
             "spans per cell; open in Perfetto)",
    )
    args = ap.parse_args(argv)

    tracer = obs_trace.start(name="dryrun") if args.trace else None

    from repro_torch.configs import ARCHS, SHAPES

    variant = {
        "tag": args.tag,
        "moe_strategy": args.moe_strategy,
        "a2a_chunks": args.a2a_chunks,
        "microbatches": args.microbatches,
        "no_fsdp": args.no_fsdp,
        "no_remat": args.no_remat,
        "fsdp_axes": args.fsdp_axes,
        "opt_fsdp_axes": args.opt_fsdp_axes or args.fsdp_axes,
        "grad_accum_dtype": args.grad_accum_dtype,
        "remat_policy": args.remat_policy,
        "serve_layout": bool(args.serve_layout),
        "wkv_chunk": args.wkv_chunk,
    }
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mk in meshes:
                    cell_id = f"{arch}__{shape}__{mk}__{args.tag}"
                    path = os.path.join(args.out, cell_id + ".json")
                    if args.skip_existing and os.path.exists(path):
                        try:
                            with open(path) as f:
                                old = json.load(f)
                            if old.get("ok") in (True, "skipped"):
                                print(f"[dryrun] {cell_id}: cached ok={old['ok']}")
                                n_ok += 1
                                continue
                        except (OSError, ValueError, AttributeError) as e:
                            # unreadable/truncated cache record — re-run the cell
                            # (json decode errors are ValueError subclasses)
                            print(f"[dryrun] {cell_id}: ignoring unreadable "
                                  f"cache record ({type(e).__name__}: {e})",
                                  file=sys.stderr)
                    rec = run_cell(arch, shape, mk, variant, args.out)
                    if rec.get("ok") in (True, "skipped"):
                        n_ok += 1
                    else:
                        n_fail += 1
                    gc.collect()  # release what the trace kept before the next cell
    finally:
        stop_world()
    if tracer is not None:
        obs_trace.stop()
        tracer.write(args.trace)
        print(f"[dryrun] trace written to {args.trace} "
              f"({len(tracer.events)} events)")
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

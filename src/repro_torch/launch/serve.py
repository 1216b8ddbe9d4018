"""Serving driver: batched prefill + greedy decode on one device.

    python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 --prompt-len 512
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke --device cpu

Ported from ``repro.launch.serve``: the same flags (plus ``--device``, which
defaults to ``cuda``), the same prompts from ``--seed``, the same
``prefill`` / ``decode.step`` spans (and a ``decode`` span around the
loop) and ``serve.*`` metrics.  ``main`` parses the flags and calls
``run``, which serves a config it is given.  Whisper and llama-vision get
the JAX package's frontend stub: random frame or patch embeddings drawn after the
prompts from the same numpy generator (``frontend_stub``).  Kernels are on
for the run.  On the card each decode step after the first is one replay of
a CUDA graph captured from the first (``models.decode.DecodeGraph``), as
the JAX package jits its decode step; the capture counts in
``serve.decode.seconds`` as JAX's first call counts its compile.

Each decode step consults the planner, as the JAX loop does:
``comms.autotune.select_allreduce_strategy`` under a ``plan`` span, on the
host between two graph replays (host floats only, no device read).  The
drills are the JAX loop's too: ``--degrade-at`` streams sagged link probes
into ``obs.health`` and refits and re-registers the machine when the link
degrades; ``--fail-at`` and ``--scenario`` lose hosts, which shrinks and
re-registers the machine (``--fail-mode shrink``) or sheds the last
in-flight sequence (``--fail-mode shed``: the caches are cut to B-1 and the
step is captured again).  At the end ``explain_bottleneck`` runs the last
payload through the event engine under a ``simulate`` span.  On one device
the plan shape is ``{"data": 1, "model": 1}``.

``--mesh-shape`` of more than one device serves across that many ranks, as
the reference does: ``tp_adapt`` for the model axis, a ``DistContext``, each
rank on its slot of the batch over the data axes, the experts over the
expert axes (a rank draws only its virtual expert of each MoE layer: the
same values the one-device draw gives it), everything else whole on each
rank.  The ranks are processes (``launch.mesh.run_entry_world``, or the
world already initialised under torchrun).  Each decode step's plan shape
is the mesh's.  A world's collectives run on the host or outside any
captured graph, so every decode step of a world runs eagerly
(``decode_step``), and the log says so.  The generations are gathered to
rank 0, which prints the lines.  The drills run on every rank of a world:
their events depend only on the step and the seed, so each rank's registry,
plan cache and counters stay alike.  A shed gathers the caches over the
data axes, cuts them to B-1 and takes the rank's slot of them again (the
whole batch on every rank where the data axes do not divide B-1, as the
reference's ``_dp_spec`` replicates it).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.comms.autotune import (
    active_machine,
    explain_bottleneck,
    select_allreduce_strategy,
)
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.machine import get_machine
from repro_torch.kernels.config import DEFAULT_DEVICE, kernels_enabled, use_kernels
from repro_torch.launch.mesh import (
    axes_index,
    build_mesh,
    dp_axes_of,
    mesh_axes,
    mesh_dims,
    run_entry_world,
)
from repro_torch.models import decode as dec
from repro_torch.models.convert import tree_map2
from repro_torch.models.moe import check_ep_layout
from repro_torch.models.transformer import (
    DistContext,
    _dp_spec,
    batch_gather,
    batch_slot,
    init_params,
)
from repro_torch.obs import drift, health, metrics, trace
from repro_torch.runtime.elastic import shrink_and_replan
from repro_torch.runtime.scenarios import HOST_DROP, Scenario, ScenarioInjector
from repro_torch.sharding.specs import PartitionSpec, Sharding, tp_adapt

# the JAX loop's plan shape on one device (its build_mesh(""))
PLAN_SHAPE = {"data": 1, "model": 1}


def _check_finite(logits: torch.Tensor, where: str) -> None:
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError(f"non-finite logits after {where}")


def frontend_stub(cfg, rng: np.random.Generator, batch: int, device) -> Optional[torch.Tensor]:
    """The stand-in for an audio or vision frontend: standard normal
    embeddings (B, frontend_tokens, frontend_dim or d_model) drawn in f32
    from ``rng`` and cast to bf16, the JAX package's draw; None for a model
    without a frontend."""
    if not cfg.frontend_tokens:
        return None
    shape = (batch, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
    embeds = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(embeds).to(device=device, dtype=torch.bfloat16)


def main(argv=None) -> np.ndarray:
    """The command line: serve ``--arch``'s published config, or its smoke
    config with ``--smoke``; returns the generations (B, new_tokens)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 1,8 => data=1, model=8: serve across 8 ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to serve on (default: cuda)")
    ap.add_argument(
        "--trace", default="", metavar="PATH",
        help="write a Chrome trace_event JSON of this run (open in Perfetto)",
    )
    ap.add_argument(
        "--metrics-out", default="", metavar="PATH",
        help="write the end-of-run metrics snapshot as JSON",
    )
    ap.add_argument(
        "--health-out", default="", metavar="PATH",
        help="write the link-health snapshot as JSON "
             "(inspect with python -m repro_torch.obs.health --load PATH)",
    )
    ap.add_argument(
        "--degrade-at", type=int, default=-1, metavar="STEP",
        help="inject a synthetic bandwidth sag on --degrade-tier from this "
             "decode step on (the degradation drill)",
    )
    ap.add_argument(
        "--degrade-tier", default="dcn", metavar="TIER",
        help="tier of the active machine to sag (default: dcn)",
    )
    ap.add_argument(
        "--degrade-factor", type=float, default=10.0,
        help="measured/predicted ratio of the injected sag",
    )
    ap.add_argument(
        "--fail-at", type=int, default=-1, metavar="STEP",
        help="inject a host loss at this decode step (chaos drill): the "
             "serve loop degrades gracefully instead of dying",
    )
    ap.add_argument(
        "--fail-host", type=int, default=0, metavar="RANK",
        help="which host rank --fail-at loses (default: 0)",
    )
    ap.add_argument(
        "--fail-mode", default="shrink", choices=("shrink", "shed"),
        help="shrink: shrink_spec + re-register the active machine so "
             "per-step planning re-decides on the surviving mesh; shed: "
             "drop one in-flight sequence (batch B -> B-1) and keep going",
    )
    ap.add_argument(
        "--scenario", default="", metavar="PATH",
        help="drive failures from a scenario JSON "
             "(python -m repro_torch.runtime.scenarios --out PATH): host_drop "
             "events map to --fail-mode handling at their step, link sags "
             "stream drift records into obs.health",
    )
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return run(cfg, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
               seed=args.seed, device=args.device, trace_path=args.trace,
               metrics_out=args.metrics_out, health_out=args.health_out,
               degrade_at=args.degrade_at, degrade_tier=args.degrade_tier,
               degrade_factor=args.degrade_factor, fail_at=args.fail_at,
               fail_host=args.fail_host, fail_mode=args.fail_mode, scenario=args.scenario,
               mesh_shape=args.mesh_shape)


def run(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int, device,
        trace_path: str = "", metrics_out: str = "", health_out: str = "",
        degrade_at: int = -1, degrade_tier: str = "dcn", degrade_factor: float = 10.0,
        fail_at: int = -1, fail_host: int = 0, fail_mode: str = "shrink",
        scenario: str = "", mesh_shape: str = "",
        report: Optional[list] = None) -> np.ndarray:
    """Serve ``cfg`` with random weights and prompts from ``seed``: batched
    prefill, then greedy decode of ``new_tokens``; returns the generations
    (B, new_tokens) int32, a shed sequence's row padded with -1 after the
    step it was shed at.  ``trace_path``, ``metrics_out`` and
    ``health_out``, where given, receive the Chrome trace, the metrics
    snapshot and the link-health snapshot; the other keywords are the drill
    flags of ``main``.  ``mesh_shape`` of more than one device serves
    across ranks (see the module docstring).  ``report``, where given, gets
    one dict a rank (one on one device): the logits of prefill's last
    position and of every decode step (1 + new_tokens, B, V) f32, the
    prefill and decode seconds, the kernels' launch counts, the peak device
    memory, the top-k experts of every MoE router call of prefill (on the
    rank's token slice in a world), and in a world the trace spans of the
    MoE collectives."""
    if fail_mode not in ("shrink", "shed"):
        raise ValueError(f"fail_mode {fail_mode!r}: one of 'shrink', 'shed'")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; pass --device cpu")
    in_world = tdist.is_initialized()
    dims, names = mesh_dims(mesh_shape, tdist.get_world_size() if in_world else 1)
    world = math.prod(dims)
    drill_kw = dict(degrade_at=degrade_at, degrade_tier=degrade_tier,
                    degrade_factor=degrade_factor, fail_at=fail_at, fail_host=fail_host,
                    fail_mode=fail_mode, scenario=scenario)
    if world > 1:
        cfg, ep_shards = tp_adapt(cfg, dict(zip(names, dims)).get("model", 1))
        if cfg.is_moe:  # before any collective
            check_ep_layout(cfg, dict(zip(names, dims))["model"], ep_shards)
        kw = dict(batch=batch, prompt_len=prompt_len, new_tokens=new_tokens, seed=seed,
                  trace_path=trace_path, metrics_out=metrics_out, health_out=health_out,
                  want_report=report is not None, drills=drill_kw)
        if in_world:
            out = [world_serve(device, cfg, mesh_shape, ep_shards, kw)]
        else:
            out = run_entry_world(world_serve, world, cfg, mesh_shape, ep_shards, kw,
                                  device=device.type)
        if report is not None:
            report.extend(r for _, r in out)
        return out[0][0]

    metrics.enable()
    tracer = trace.start(name="serve") if trace_path else None
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    B, P_len, N = batch, prompt_len, new_tokens
    capacity = P_len + N
    rng = np.random.default_rng(seed)
    prompts = rng.integers(2, cfg.vocab_size, size=(B, P_len), dtype=np.int32)
    tokens = torch.from_numpy(prompts).to(device)
    frontend = frontend_stub(cfg, rng, B, device)

    was_on = kernels_enabled()
    use_kernels(True)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # weights and prompts are in place
        t0 = time.perf_counter()
        routes = [] if report is not None and cfg.is_moe else None
        with trace.span("prefill", batch=B, prompt_len=P_len), _recording_routes(routes):
            logits, caches = dec.prefill(cfg, params, tokens, frontend=frontend,
                                         capacity=capacity)
            _check_finite(logits, "prefill")  # waits for the device
        t_prefill = time.perf_counter() - t0
        metrics.observe("serve.prefill.seconds", t_prefill)
        print(f"[serve] prefill {B}x{P_len} in {t_prefill:.3f}s "
              f"({B * P_len / t_prefill:.0f} tok/s)")

        seen = None
        if report is not None:  # every step's logits, copied on the device; NaN once shed
            seen = logits.new_full((N + 1,) + tuple(logits.shape), float("nan"))
            seen[0].copy_(logits)
        steps = dec.DecodeGraph(cfg, params, caches, logits.argmax(dim=-1)[:, None], P_len, N)
        del caches  # the graph holds them; a shed replaces them
        drills = _Drills(lambda: steps.batch,
                         lambda b: steps.shed(dec.cut_caches(cfg, steps.caches, b, capacity)),
                         print, **drill_kw)
        token_bytes = float(B * cfg.d_model) * 2  # bf16 activations per token
        t0 = time.perf_counter()
        with trace.span("decode", new_tokens=N):
            for i in range(N):
                with trace.span("decode.step", token=i):
                    drills.before_step(i)
                    with trace.span("plan"):
                        collective = select_allreduce_strategy(
                            PLAN_SHAPE, token_bytes * (P_len + i + 1))
                    logits = steps.step()
                    if seen is not None:
                        seen[i + 1, :steps.batch].copy_(logits)
                metrics.inc("serve.decode.tokens", steps.batch)
            _check_finite(logits, "decode")  # waits for the device
        t_dec = time.perf_counter() - t0
    finally:
        use_kernels(was_on)
    metrics.observe("serve.decode.seconds", t_dec)
    print(f"[serve] per-step plan: {collective}")
    if steps.capture_seconds > 0.0:
        metrics.observe("serve.decode.first_step.seconds", steps.first_step_seconds)
        metrics.observe("serve.decode.warmup.seconds", steps.warmup_seconds)
        metrics.observe("serve.decode.capture.seconds", steps.capture_seconds)
        print(f"[serve] decode step captured as one CUDA graph in {steps.capture_seconds:.3f}s; "
              f"step 0 (its eager warm-up, {steps.warmup_seconds:.3f}s) and the capture took "
              f"{steps.first_step_seconds:.3f}s, steps 1..{N - 1} replay it")
        for sec in steps.recapture_seconds:
            metrics.observe("serve.decode.recapture.seconds", sec)
            print(f"[serve] decode step captured again after a shed in {sec:.3f}s")

    # the last payload through the event engine: the trace carries the
    # per-resource timeline and bottleneck attribution of what the plan means
    # in simulated time (on one device the selector runs no engine)
    with trace.span("simulate"):
        bottleneck = explain_bottleneck(None, token_bytes * (P_len + N), n_msgs=1)
    metrics.gauge("serve.simulated_makespan_s", bottleneck.makespan)

    gen = steps.tokens.to(torch.int32).cpu().numpy()
    if report is not None:
        report.append({"logits": seen.cpu().numpy(), "prefill_seconds": t_prefill,
                       "decode_seconds": t_dec, "launches": launch_counts(),
                       "peak_bytes": _peak_bytes(device), "routes": routes})
    print(f"[serve] decoded {N} tokens x {B} seqs in {t_dec:.3f}s "
          f"({B * N / t_dec:.1f} tok/s)")
    print("[serve] sample generations (first 3 rows):")
    for row in gen[:3]:
        print("   ", row[:16].tolist())

    if tracer is not None:
        trace.stop()
        tracer.write(trace_path)
        print(f"[serve] trace written to {trace_path} ({len(tracer.events)} events)")
    if metrics_out:
        metrics.write(metrics_out)
        print(f"[serve] metrics written to {metrics_out}")
    if health_out:
        with open(health_out, "w") as f:
            json.dump(health.monitor().snapshot(), f, indent=2)
            f.write("\n")
        print(f"[serve] health written to {health_out}")
    print("[serve] metrics:",
          metrics.summary_line(prefixes=["serve.", "plan_cache.", "lowering_memo.",
                                         "engine.", "health.", "runtime."]))
    return gen


@contextlib.contextmanager
def _recording_routes(routes: Optional[list]):
    """While on, every MoE router call appends its top-k expert indices (a
    host copy) to ``routes``; None records nothing."""
    if routes is None:
        yield
        return
    from repro_torch.models import moe

    route = moe._route

    def recording(cfg, router_w, x):
        gates, idx, aux = route(cfg, router_w, x)
        routes.append(idx.cpu())
        return gates, idx, aux

    moe._route = recording
    try:
        yield
    finally:
        moe._route = route


def launch_counts() -> dict:
    """Kernel name -> (launches, plain-version calls) in this process."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel, ops as fa_ops
    from repro_torch.kernels.rglru import kernel as lru_kernel, ops as lru_ops
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel, ops as wkv_ops

    return {"flash_attention": (fa_kernel.launches, fa_ops.plain_calls),
            "wkv6": (wkv_kernel.launches, wkv_ops.plain_calls),
            "rglru_scan": (lru_kernel.launches, lru_ops.plain_calls)}


def _peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _cache_batch_axes(cfg, capacity: int):
    """Each cache leaf's batch axis (leaves are stacked over a group's
    count, so it is not the first), None for a leaf without one (a ring's
    positions): the axis whose size follows the batch on the meta device."""
    one = dec.init_caches(cfg, 1, capacity, device="meta")
    two = dec.init_caches(cfg, 2, capacity, device="meta")
    return tree_map2(lambda a, b: next((d for d in range(a.dim()) if a.shape[d] != b.shape[d]),
                                       None), one, two)


def _cache_sharding(dist: DistContext, axis: int, batch: int, ndim: int) -> Sharding:
    """A cache leaf's slot at ``batch`` live rows: its batch axis over the
    data axes where they divide ``batch``, else the whole leaf (``_dp_spec``)."""
    entries = [None] * ndim
    entries[axis] = _dp_spec(dist, batch, 1)[0]
    return Sharding(dist.mesh, PartitionSpec(*entries))


def world_serve(device: torch.device, cfg, mesh_shape: str, ep_shards: int,
                kw: dict) -> tuple:
    """One rank's serve run in a world: (the whole generations, this
    rank's report or None).  The report adds the metrics snapshot and the
    lines the rank logs (rank 0 prints them)."""
    mesh = build_mesh(mesh_shape, device.type)
    dist = DistContext(mesh=mesh, dp_axes=dp_axes_of(mesh) or ("data",), ep_shards=ep_shards)
    log = tdist.get_rank() == 0
    said = []

    def say(*parts) -> None:
        line = " ".join(str(p) for p in parts)
        said.append(line)
        if log:
            print(line, flush=True)

    B, P_len, N, seed = kw["batch"], kw["prompt_len"], kw["new_tokens"], kw["seed"]
    capacity = P_len + N
    plan_shape = mesh_axes(mesh)
    metrics.enable()
    tracer = trace.start(name="serve") if kw["trace_path"] or kw["want_report"] else None
    block = None
    if cfg.is_moe:  # this rank's virtual expert of each MoE layer
        per = cfg.n_experts * ep_shards // dist.ep_size
        block = (axes_index(mesh, dist.ep_axes) * per, per)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         ep_shards=ep_shards, expert_block=block)
    if device.type == "cuda":  # the draw's f32 scratch: ranks share the card
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    prompts = rng.integers(2, cfg.vocab_size, size=(B, P_len), dtype=np.int32)
    tokens = batch_slot(dist, torch.from_numpy(prompts).to(device))
    frontend = frontend_stub(cfg, rng, B, device)
    if frontend is not None:
        frontend = batch_slot(dist, frontend)

    was_on = kernels_enabled()
    use_kernels(True)
    segments, seen = [], []  # the report's logits: whole ones per layout, this rank's
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        routes = [] if kw["want_report"] and cfg.is_moe else None
        with trace.span("prefill", batch=B, prompt_len=P_len), _recording_routes(routes):
            logits, caches = dec.prefill(cfg, params, tokens, frontend=frontend,
                                         capacity=capacity, dist=dist)
            _check_finite(logits, "prefill")
        t_prefill = time.perf_counter() - t0
        metrics.observe("serve.prefill.seconds", t_prefill)
        say(f"[serve] prefill {B}x{P_len} in {t_prefill:.3f}s "
            f"({B * P_len / t_prefill:.0f} tok/s) on {tdist.get_world_size()} ranks, "
            f"mesh {plan_shape}")
        token_bytes = float(B * cfg.d_model) * 2  # bf16 activations per token
        tok = logits.argmax(dim=-1, keepdim=True)
        gen = torch.full((tok.shape[0], N), -1, dtype=torch.int32, device=device)
        whole = torch.full((B, N), -1, dtype=torch.int32, device=device)
        live = B
        if kw["want_report"]:
            seen.append(logits)
        axes = _cache_batch_axes(cfg, capacity)

        def close_segment() -> None:
            if seen:  # (steps, B, V), NaN in rows already shed
                got = batch_gather(dist, torch.stack(seen, 1), live)
                seg = got.new_full((got.shape[1], B, got.shape[2]), float("nan"))
                seg[:, :live] = got.transpose(0, 1)
                segments.append(seg)
                seen.clear()

        def shed(new_b: int) -> None:
            nonlocal caches, tok, gen, live
            close_segment()
            full = tree_map2(lambda c, ax: c if ax is None else
                             _cache_sharding(dist, ax, live, c.dim()).gather(c), caches, axes)
            cut = dec.cut_caches(cfg, full, new_b, capacity)
            del full
            caches = tree_map2(lambda c, ax: c if ax is None else
                               _cache_sharding(dist, ax, new_b, c.dim()).shard(c), cut, axes)
            tok = batch_slot(dist, batch_gather(dist, tok, live)[:new_b])
            rows = batch_gather(dist, gen, live)
            whole[:live] = rows
            gen = batch_slot(dist, rows[:new_b])
            live = new_b

        drills = _Drills(lambda: live, shed, say, **kw["drills"])
        walls = []
        t0 = time.perf_counter()
        with trace.span("decode", new_tokens=N):
            for i in range(N):
                t1 = time.perf_counter()
                with trace.span("decode.step", token=i):
                    gen[:, i] = tok[:, 0]
                    drills.before_step(i)
                    with trace.span("plan"):
                        collective = select_allreduce_strategy(
                            plan_shape, token_bytes * (P_len + i + 1))
                    logits, caches = dec.decode_step(cfg, params, caches, tok, P_len + i,
                                                     dist=dist)
                    tok = logits.argmax(dim=-1, keepdim=True)
                    if kw["want_report"]:
                        seen.append(logits)
                    _check_finite(logits, "decode")  # waits for the device
                walls.append(time.perf_counter() - t1)
                metrics.inc("serve.decode.tokens", live)
        t_dec = time.perf_counter() - t0
    finally:
        use_kernels(was_on)
    metrics.observe("serve.decode.seconds", t_dec)
    whole[:live] = batch_gather(dist, gen, live)
    close_segment()
    say(f"[serve] per-step plan: {collective}")
    say(f"[serve] decode ran eagerly on every step: a world's collectives run outside "
        f"a CUDA graph ({tdist.get_world_size()} ranks)")

    # the last payload through the event engine, as on one device
    with trace.span("simulate"):
        bottleneck = explain_bottleneck(None, token_bytes * (P_len + N), n_msgs=1)
    metrics.gauge("serve.simulated_makespan_s", bottleneck.makespan)
    if tracer is not None:
        trace.stop()
    rep = None
    if kw["want_report"]:
        spans = [(e["name"], e.get("args", {}).get("which", ""), e["dur"] * 1e-6)
                 for e in tracer.events if e.get("ph") == "X" and e.get("pid") == 0]
        rep = {"logits": torch.cat(segments).float(),
               "prefill_seconds": t_prefill, "decode_seconds": t_dec, "step_seconds": walls,
               "launches": launch_counts(), "peak_bytes": _peak_bytes(device),
               "spans": spans, "routes": routes, "metrics": metrics.to_json(), "lines": said}
    say(f"[serve] decoded {N} tokens x {B} seqs in {t_dec:.3f}s ({B * N / t_dec:.1f} tok/s)")
    say("[serve] sample generations (first 3 rows):")
    for row in whole[:3].cpu().numpy():
        say("   ", row[:16].tolist())
    if log:
        if tracer is not None and kw["trace_path"]:
            tracer.write(kw["trace_path"])
            print(f"[serve] trace written to {kw['trace_path']} ({len(tracer.events)} events)")
        if kw["metrics_out"]:
            metrics.write(kw["metrics_out"])
            print(f"[serve] metrics written to {kw['metrics_out']}")
        if kw["health_out"]:
            with open(kw["health_out"], "w") as f:
                json.dump(health.monitor().snapshot(), f, indent=2)
                f.write("\n")
            print(f"[serve] health written to {kw['health_out']}")
    say("[serve] metrics:",
        metrics.summary_line(prefixes=["serve.", "plan_cache.", "lowering_memo.",
                                       "engine.", "health.", "runtime."]))
    return whole, rep


class _Drills:
    """The JAX serve loop's degradation and chaos drills, run on the host
    before each decode step (``before_step``), in its order: the link probe
    and health check, the scenario's drift, then the host drops.

    Degradation (``degrade_at``): from that step on, each step's probe of
    ``degrade_tier`` comes back ``degrade_factor`` times slower than the
    active machine's model; the drift records stream into ``obs.health``,
    and when the link degrades the machine is refitted from the sagged
    samples and re-registered, so the next consult re-plans.  Host drops
    (``fail_at``/``fail_host`` and a scenario's ``host_drop`` events): in
    shrink mode the machine's surviving-mesh spec is re-registered
    (``runtime.elastic.shrink_and_replan``); in shed mode the last in-flight
    sequence is dropped: ``shed(B - 1)`` with ``batch()`` the live batch.
    ``say`` logs a line."""

    def __init__(self, batch, shed, say, *, degrade_at: int, degrade_tier: str,
                 degrade_factor: float, fail_at: int, fail_host: int, fail_mode: str,
                 scenario: str):
        self.batch, self.shed, self.say = batch, shed, say
        self.degrade_at, self.degrade_tier = degrade_at, degrade_tier
        self.degrade_factor, self.fail_mode = degrade_factor, fail_mode
        self.machine = active_machine()
        self.degrade_spec = get_machine(self.machine) if degrade_at >= 0 else None
        self.probe_bytes = float(1 << 20)
        self.refit_done = False
        self.drop_at: dict = {}  # decode step -> [host ranks lost there]
        self.injector = None
        if scenario:
            sc = Scenario.load(scenario)
            for ev in sc.events:
                if ev.kind == HOST_DROP:
                    self.drop_at.setdefault(ev.at, []).append(ev.host)
            self.injector = ScenarioInjector(sc, machine=self.machine,
                                             spec=get_machine(self.machine))
            say(f"[serve] scenario {sc.name!r} (seed {sc.seed}): {len(sc.events)} events")
        if fail_at >= 0:
            self.drop_at.setdefault(fail_at, []).append(fail_host)

    def before_step(self, i: int) -> None:
        if self.degrade_spec is not None:
            self._probe(i)
        if self.injector is not None:
            self.injector.feed_drift(i)
        for host in self.drop_at.pop(i, ()):
            self._host_drop(i, host)

    def _probe(self, i: int) -> None:
        tier = self.degrade_spec.tiers[self.degrade_tier]
        t_model = float(tier.time(self.probe_bytes))
        sag = self.degrade_factor if i >= self.degrade_at else 1.0
        drift.record(self.machine, self.degrade_tier, "probe", self.probe_bytes,
                     t_model, sag * t_model)
        lk = health.monitor().link(self.machine, self.degrade_tier)
        if lk.state == health.DEGRADED and not self.refit_done:
            self.refit_done = True
            fit, _ = health.refit_degraded(self.degrade_spec, lk, register_as=self.machine)
            self.say(f"[serve] link {lk.key} degraded at decode step {i} "
                     f"(detected in {lk.detection_records} records); "
                     f"refit beta x{fit.beta_scale:.1f}, replanning")

    def _host_drop(self, step: int, host: int) -> None:
        metrics.inc("runtime.elastic.host_drops")
        iid = trace.begin_interval(f"host_drop:{host}", cat="elastic", step=step,
                                   mode=self.fail_mode)
        if self.fail_mode == "shrink":
            shrunk = shrink_and_replan(self.machine, [host])
            metrics.inc("runtime.elastic.replans")
            survivors = int(shrunk.facts["n_gpus"])
            self.say(f"[serve] host {host} lost at decode step {step}; "
                     f"shrunk {self.machine!r} to {survivors} ranks "
                     f"(fingerprint {shrunk.fingerprint[:12]}), replanning")
            trace.end_interval(f"host_drop:{host}", iid, cat="elastic", survivors=survivors)
            return
        new_b = self.batch() - 1
        if new_b < 1:
            self.say(f"[serve] host {host} lost at decode step {step}; "
                     f"batch already minimal, continuing")
            trace.end_interval(f"host_drop:{host}", iid, cat="elastic")
            return
        self.shed(new_b)
        metrics.inc("runtime.elastic.shed")
        metrics.gauge("serve.batch.live", new_b)
        self.say(f"[serve] host {host} lost at decode step {step}; "
                 f"shed one sequence (batch {new_b + 1} -> {new_b})")
        trace.end_interval(f"host_drop:{host}", iid, cat="elastic", batch=new_b)


if __name__ == "__main__":
    main()

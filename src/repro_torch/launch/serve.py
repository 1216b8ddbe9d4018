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
payload through the event engine under a ``simulate`` span.  The plan shape
is one device's, ``{"data": 1, "model": 1}``; ``--mesh-shape`` comes with
distribution.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.comms.autotune import (
    active_machine,
    explain_bottleneck,
    select_allreduce_strategy,
)
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.machine import get_machine
from repro_torch.kernels.config import DEFAULT_DEVICE, kernels_enabled, use_kernels
from repro_torch.models import decode as dec
from repro_torch.models.transformer import init_params
from repro_torch.obs import drift, health, metrics, trace
from repro_torch.runtime.elastic import shrink_and_replan
from repro_torch.runtime.scenarios import HOST_DROP, Scenario, ScenarioInjector

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
               fail_host=args.fail_host, fail_mode=args.fail_mode, scenario=args.scenario)


def run(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int, device,
        trace_path: str = "", metrics_out: str = "", health_out: str = "",
        degrade_at: int = -1, degrade_tier: str = "dcn", degrade_factor: float = 10.0,
        fail_at: int = -1, fail_host: int = 0, fail_mode: str = "shrink",
        scenario: str = "") -> np.ndarray:
    """Serve ``cfg`` with random weights and prompts from ``seed``: batched
    prefill, then greedy decode of ``new_tokens``; returns the generations
    (B, new_tokens) int32, a shed sequence's row padded with -1 after the
    step it was shed at.  ``trace_path``, ``metrics_out`` and
    ``health_out``, where given, receive the Chrome trace, the metrics
    snapshot and the link-health snapshot; the other keywords are the drill
    flags of ``main``."""
    if fail_mode not in ("shrink", "shed"):
        raise ValueError(f"fail_mode {fail_mode!r}: one of 'shrink', 'shed'")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; pass --device cpu")

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
        with trace.span("prefill", batch=B, prompt_len=P_len):
            logits, caches = dec.prefill(cfg, params, tokens, frontend=frontend,
                                         capacity=capacity)
            _check_finite(logits, "prefill")  # waits for the device
        t_prefill = time.perf_counter() - t0
        metrics.observe("serve.prefill.seconds", t_prefill)
        print(f"[serve] prefill {B}x{P_len} in {t_prefill:.3f}s "
              f"({B * P_len / t_prefill:.0f} tok/s)")

        steps = dec.DecodeGraph(cfg, params, caches, logits.argmax(dim=-1)[:, None], P_len, N)
        del caches  # the graph holds them; a shed replaces them
        drills = _Drills(cfg, capacity, steps, degrade_at=degrade_at,
                         degrade_tier=degrade_tier, degrade_factor=degrade_factor,
                         fail_at=fail_at, fail_host=fail_host, fail_mode=fail_mode,
                         scenario=scenario)
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
                metrics.inc("serve.decode.tokens", steps.batch)
            _check_finite(logits, "decode")  # waits for the device
        t_dec = time.perf_counter() - t0
    finally:
        use_kernels(was_on)
    metrics.observe("serve.decode.seconds", t_dec)
    print(f"[serve] per-step plan: {collective}")
    if steps.capture_seconds > 0.0:
        metrics.observe("serve.decode.first_step.seconds", steps.first_step_seconds)
        metrics.observe("serve.decode.capture.seconds", steps.capture_seconds)
        print(f"[serve] decode step captured as one CUDA graph in {steps.capture_seconds:.3f}s; "
              f"step 0 (its eager warm-up) and the capture took "
              f"{steps.first_step_seconds:.3f}s, steps 1..{N - 1} replay it")
        for sec in steps.recapture_seconds:
            metrics.observe("serve.decode.recapture.seconds", sec)
            print(f"[serve] decode step captured again after a shed in {sec:.3f}s")

    # the last payload through the event engine: the trace carries the
    # per-resource timeline and bottleneck attribution of what the plan means
    # in simulated time (on one device the selector runs no engine)
    with trace.span("simulate"):
        report = explain_bottleneck(None, token_bytes * (P_len + N), n_msgs=1)
    metrics.gauge("serve.simulated_makespan_s", report.makespan)

    gen = steps.tokens.to(torch.int32).cpu().numpy()
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
    sequence is dropped (``DecodeGraph.shed`` on caches cut to B-1)."""

    def __init__(self, cfg, capacity: int, steps: "dec.DecodeGraph", *, degrade_at: int,
                 degrade_tier: str, degrade_factor: float, fail_at: int, fail_host: int,
                 fail_mode: str, scenario: str):
        self.cfg, self.capacity, self.steps = cfg, capacity, steps
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
            print(f"[serve] scenario {sc.name!r} (seed {sc.seed}): {len(sc.events)} events")
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
            print(f"[serve] link {lk.key} degraded at decode step {i} "
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
            print(f"[serve] host {host} lost at decode step {step}; "
                  f"shrunk {self.machine!r} to {survivors} ranks "
                  f"(fingerprint {shrunk.fingerprint[:12]}), replanning")
            trace.end_interval(f"host_drop:{host}", iid, cat="elastic", survivors=survivors)
            return
        new_b = self.steps.batch - 1
        if new_b < 1:
            print(f"[serve] host {host} lost at decode step {step}; "
                  f"batch already minimal, continuing")
            trace.end_interval(f"host_drop:{host}", iid, cat="elastic")
            return
        self.steps.shed(dec.cut_caches(self.cfg, self.steps.caches, new_b, self.capacity))
        metrics.inc("runtime.elastic.shed")
        metrics.gauge("serve.batch.live", new_b)
        print(f"[serve] host {host} lost at decode step {step}; "
              f"shed one sequence (batch {new_b + 1} -> {new_b})")
        trace.end_interval(f"host_drop:{host}", iid, cat="elastic", batch=new_b)


if __name__ == "__main__":
    main()

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
``serve.decode.seconds`` as JAX's first call counts its compile.  The JAX
loop's per-step planner consult and its failure drills (``--degrade-at``,
``--fail-at``, ``--scenario``) are not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels.config import DEFAULT_DEVICE, kernels_enabled, use_kernels
from repro_torch.models import decode as dec
from repro_torch.models.transformer import init_params
from repro_torch.obs import metrics, trace


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
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return run(cfg, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
               seed=args.seed, device=args.device, trace_path=args.trace,
               metrics_out=args.metrics_out)


def run(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int, device,
        trace_path: str = "", metrics_out: str = "") -> np.ndarray:
    """Serve ``cfg`` with random weights and prompts from ``seed``: batched
    prefill, then greedy decode of ``new_tokens``; returns the generations
    (B, new_tokens) int32.  ``trace_path`` and ``metrics_out``, where given,
    receive the Chrome trace and the metrics snapshot."""
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
        t0 = time.perf_counter()
        with trace.span("decode", new_tokens=N):
            for i in range(N):
                with trace.span("decode.step", token=i):
                    logits = steps.step()
                metrics.inc("serve.decode.tokens", B)
            _check_finite(logits, "decode")  # waits for the device
        t_dec = time.perf_counter() - t0
    finally:
        use_kernels(was_on)
    metrics.observe("serve.decode.seconds", t_dec)
    if steps.graph is not None:
        metrics.observe("serve.decode.first_step.seconds", steps.first_step_seconds)
        print(f"[serve] decode step captured as one CUDA graph in {steps.capture_seconds:.3f}s; "
              f"step 0 (its eager warm-up) and the capture took "
              f"{steps.first_step_seconds:.3f}s, steps 1..{N - 1} replay it")

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
    print("[serve] metrics:", metrics.summary_line(prefixes=["serve."]))
    return gen


if __name__ == "__main__":
    main()

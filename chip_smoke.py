#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines, any failure ending the run non-zero:
  1. device  — fail without CUDA; print the card's name and power limit;
               TF32 off for f32 matmuls and convolutions.
  2. build   — compile every CUDA kernel from the repository's sources.
  3. kernels — each kernel against its plain PyTorch version on the card.
  4. parity  — the smoke-width model in f32: CPU (plain) against CUDA (kernel).
  5. serve   — full-width llama3.2-1b through ``repro_torch.launch.serve``;
               every kernel of the path must have launched.
  6. breakdown — the same serve call again: every run's prefill and decode
               wall time, then one run under torch.profiler split by serve's
               own ``prefill`` / ``decode`` spans: device busy time, idle
               share, device operations and the largest kernels per phase.
  7. timing  — each kernel at the serving path's shape, beside its plain
               version, one PyTorch library call and the card's bound.
The second-to-last line is the card as nvidia-smi names it, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks (NVIDIA data sheets, SXM parts, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s.  f32 inputs are bounded by the 67 TFLOP/s of the
# CUDA cores.
PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}
F32_FLOPS = 67e12
MAIN_SHAPE = dict(B=4, H=32, G=8, S=512, dh=64, dtype=torch.bfloat16)
# f32: the kernel sums in another order; bf16: well above the rounding of
# bf16 outputs (about 4e-3 at these magnitudes), well below the outputs' size
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SERVE_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "512",
              "--new-tokens", "32", "--device", "cuda"]
WARM_RUNS = 5

FA_CASES = [
    # (label, B, H, G, Sq, Sk, dh, dtype, kwargs); the first seven replay the
    # JAX package's own kernel cases
    ("fa_case0", 1, 2, 2, 128, 128, 64, torch.float32, {}),
    ("fa_case1_window", 2, 4, 2, 256, 256, 64, torch.float32, {"window": 64}),
    ("fa_case2_mqa_dh128", 1, 8, 1, 128, 128, 128, torch.float32, {}),
    ("fa_case3_noncausal", 2, 2, 2, 192, 192, 64, torch.float32, {"causal": False}),
    ("fa_case4_bf16", 1, 2, 2, 256, 256, 64, torch.bfloat16, {}),
    ("fa_case5_softcap", 1, 2, 2, 128, 128, 64, torch.float32, {"softcap": 20.0}),
    ("fa_case6_window_softcap", 1, 2, 2, 128, 128, 64, torch.float32,
     {"window": 32, "softcap": 10.0}),
    ("main_path", 4, 32, 8, 512, 512, 64, torch.bfloat16, {}),
    ("main_path_f32", 4, 32, 8, 512, 512, 64, torch.float32, {}),
    ("dh128_bf16", 2, 8, 2, 384, 384, 128, torch.bfloat16, {}),
    ("dh256_bf16", 1, 4, 2, 256, 256, 256, torch.bfloat16, {"window": 100}),
    ("dh256_f32", 1, 4, 2, 200, 200, 256, torch.float32, {"softcap": 30.0}),
    ("smoke_dh32", 2, 4, 2, 40, 40, 32, torch.float32, {}),
    ("ragged_s200", 2, 4, 2, 200, 200, 64, torch.float32, {}),
    ("ragged_bf16_window", 2, 4, 2, 333, 333, 64, torch.bfloat16, {"window": 50}),
    ("q_offset_tail", 1, 2, 2, 64, 256, 64, torch.float32, {"q_offset": 192}),
    ("q_offset_ragged", 2, 4, 1, 37, 301, 64, torch.float32, {"q_offset": 264}),
]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 21, iters: int = 10, warmup: int = 5) -> float:
    """Device ms per call: median over ``reps`` CUDA-event timings of
    ``iters`` back-to-back calls each, after a warm-up.  Back to back, the
    queue stays full, so host-side work between launches is not counted
    as long as it is shorter than the device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def model_layout(rng, B, H, G, Sq, Sk, dh, dtype, device="cuda"):
    """q (B, Sq, H, dh), k, v (B, Sk, G, dh) as the model makes them."""
    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    return mk(B, Sq, H, dh), mk(B, Sk, G, dh), mk(B, Sk, G, dh)


# -- phases --------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("[device] FAIL: no CUDA GPU visible (torch.cuda.is_available() is False); "
              "this script runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    line = gpu_line()
    say("device", f"{line} | torch {torch.__version__} cuda {torch.version.cuda} | "
                  f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", "TF32 off: torch.backends.cuda.matmul.allow_tf32=False, "
                  "torch.backends.cudnn.allow_tf32=False")
    return line


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build()
    say("build", f"built {sorted(seconds)} in {time.perf_counter() - t0:.2f}s "
                 f"(per kernel: {seconds})")
    for name in seconds:
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                say("build", f"{name}: {ln.strip()}")


def phase_kernel_cases() -> float:
    """Kernel against attention_ref on the same CUDA tensors; returns the
    max abs error at the serving path's shape."""
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(0)
    main_err = None
    for label, B, H, G, Sq, Sk, dh, dtype, kw in FA_CASES:
        q, k, v = model_layout(rng, B, H, G, Sq, Sk, dh, dtype)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = kernel.flash_attention(qt, kt, vt, **kw)
        ref = attention_ref(qt, kt, vt, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dtype]
        bad = (out.float() - ref.float()).abs() > tol + tol * ref.float().abs()
        ok = not bool(bad.any()) and bool(torch.isfinite(out).all())
        say("kernels", f"{label}: B={B} H={H} G={G} Sq={Sq} Sk={Sk} dh={dh} "
                       f"{str(dtype)[6:]} {kw} max_abs_err={err:.3e} tol={tol:g} "
                       f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with attention_ref in {label}")
        if label == "main_path":
            main_err = err
            # the model-layout entry point the serve path calls
            o2 = ops.attention(q, k, v, **kw)
            if not torch.equal(o2, out.transpose(1, 2)):
                raise AssertionError("ops.attention differs from the kernel it wraps")
    return main_err


def phase_parity() -> None:
    """Smoke-width llama in f32, one set of weights: prefill + decode on the
    CPU (plain attention) against CUDA (the kernel)."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import use_kernels
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models import decode as dec
    from repro_torch.models.convert import tree_map
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    B, P, N = 2, 40, 6
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(B, P))
    use_kernels(True)
    try:
        tok_cpu = torch.from_numpy(prompts)
        launches0 = kernel.launches
        lg_c, cache_c = dec.prefill(cfg, params, tok_cpu, capacity=P + N)
        lg_g, cache_g = dec.prefill(cfg, params_gpu, tok_cpu.cuda(), capacity=P + N)
        launched = kernel.launches - launches0
        worst = (lg_g.cpu() - lg_c).abs().max().item()
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=1e-4)
        for i in range(N):
            tok = lg_c.argmax(-1)[:, None]  # both sides decode the CPU's pick
            lg_c, cache_c = dec.decode_step(cfg, params, cache_c, tok, P + i)
            lg_g, cache_g = dec.decode_step(cfg, params_gpu, cache_g, tok.cuda(), P + i)
            worst = max(worst, (lg_g.cpu() - lg_c).abs().max().item())
            torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=1e-4)
    finally:
        use_kernels(False)
    if launched != cfg.n_layers:
        raise AssertionError(f"CUDA prefill launched the kernel {launched} times, "
                             f"expected {cfg.n_layers}")
    say("parity", f"{cfg.name} f32 B={B} prompt={P}: prefill + {N} decode steps, "
                  f"CUDA vs CPU logits max abs diff {worst:.3e} (tol 1e-4), "
                  f"{launched} kernel launches in the CUDA prefill")


def phase_serve(gpu: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.launch import serve
    from repro_torch.obs import metrics

    cfg = get_config("llama3.2-1b")
    B, P, N = 4, 512, 32
    kernel.launches = 0
    ops.plain_calls = 0
    torch.cuda.reset_peak_memory_stats()
    gen = serve.main(SERVE_ARGV)
    launches = {"flash_attention": kernel.launches}
    plain = ops.plain_calls
    peak = torch.cuda.max_memory_allocated()
    if gen.shape != (B, N) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"generations {gen.shape} out of range")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} "
                             f"times in serve, expected {cfg.n_layers} (one per layer)")
    if plain:
        raise AssertionError(f"{plain} attention calls took the plain version on the card")
    reg = metrics.registry()
    t_pre = reg.histograms["serve.prefill.seconds"].total
    t_dec = reg.histograms["serve.decode.seconds"].total
    say("serve", f"{cfg.name} bf16 B={B} prompt={P} new={N}, first full-width run in this "
                 f"process: prefill {B * P / t_pre:.1f} tok/s "
                 f"({t_pre * 1e3:.2f} ms), decode {B * N / t_dec:.2f} tok/s "
                 f"({t_dec / N * 1e3:.3f} ms/step), peak memory {peak / 2**30:.3f} GiB, "
                 f"flash_attention launches {launches['flash_attention']}, "
                 f"plain attention calls on the card {plain} | {gpu}")
    return launches


def serve_quietly() -> tuple:
    """One more ``serve.main(SERVE_ARGV)`` with its printing held back: the
    (prefill, decode) wall seconds its metrics recorded."""
    from repro_torch.launch import serve
    from repro_torch.obs import metrics

    hist = [metrics.registry().histogram(f"serve.{k}.seconds") for k in ("prefill", "decode")]
    before = [h.total for h in hist]
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(SERVE_ARGV)
    return tuple(h.total - b for h, b in zip(hist, before))


def phase_breakdown(gpu: str) -> None:
    """Where serve's time goes.  Wall times come from ``WARM_RUNS`` runs
    without the profiler; device busy time (the sum of the device operations'
    times, one stream, so they do not overlap) from one run under
    torch.profiler, each operation assigned to the serve span (``prefill``,
    ``decode``) its start falls in.  Both spans end in a synchronise, so
    every operation of a phase starts inside its span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config

    n_layers, N = get_config("llama3.2-1b").n_layers, 32
    walls = [serve_quietly() for _ in range(WARM_RUNS)]
    for r, (t_pre, t_dec) in enumerate(walls, 1):
        say("breakdown", f"run {r}: prefill {t_pre * 1e3:.3f} ms, "
                         f"decode {t_dec / N * 1e3:.3f} ms/step")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_quietly()
    events = prof.events()
    spans = {e.name: e.time_range for e in events
             if e.device_type == DeviceType.CPU and e.name in ("prefill", "decode")}
    device_ops = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.name not in ("prefill", "decode", "decode.step")]
    for i, (phase, per) in enumerate((("prefill", 1), ("decode", N))):
        span = spans[phase]
        ops = [e for e in device_ops if span.start <= e.time_range.start < span.end]
        busy_us = sum(e.time_range.elapsed_us() for e in ops)
        flash = sum("flash_fwd" in e.name for e in ops)
        if not ops or flash != (n_layers if phase == "prefill" else 0):
            raise AssertionError(f"profile of {phase}: {len(ops)} device operations, "
                                 f"{flash} flash kernels")
        wall_us = sorted(w[i] * 1e6 / per for w in walls)
        idle = [1 - busy_us / per / w for w in wall_us]
        unit = "step" if per > 1 else "call"
        say("breakdown", f"{phase} per {unit}: wall without profiler {wall_us[0]:.1f} .. "
                         f"{statistics.median(wall_us):.1f} .. {wall_us[-1]:.1f} us "
                         f"(min .. median .. max of {len(walls)}), under the profiler "
                         f"{span.elapsed_us() / per:.1f} us, device busy {busy_us / per:.1f} us, "
                         f"idle share {idle[0]:.3f} .. {idle[-1]:.3f}, "
                         f"{len(ops) / per:.0f} device operations, {flash} flash kernels | {gpu}")
        by_name = {}
        for e in ops:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            say("breakdown", f"  {phase}: {t / per:9.1f} us {100 * t / busy_us:5.1f}% "
                             f"x{c / per:<6g} {name[:90]}")


def phase_timing(gpu: str, launches: dict, main_err: float) -> dict:
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    s = MAIN_SHAPE
    B, H, G, S, dh, dtype = s["B"], s["H"], s["G"], s["S"], s["dh"], s["dtype"]
    q, k, v = model_layout(np.random.default_rng(1), B, H, G, S, S, dh, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    n_launch = kernel.launches
    ms = time_ms(lambda: kernel.flash_attention(qt, kt, vt, causal=True))
    plain_ms = time_ms(lambda: attention_ref(qt, kt, vt, causal=True))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    kernel.launches = n_launch  # timing launches are not the main path's

    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * el  # q, o, k, v once each
    flops = 4 * dh * B * H * S * (S + 1) // 2  # QK^T and PV over the causal pairs
    bw, peak = next((p for n, p in PEAKS.items() if n in gpu), PEAKS["H100"])
    peak = peak if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    row = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
        "launches": launches["flash_attention"],
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }
    say("timing", f"flash_attention B={B} H={H} G={G} S={S} dh={dh} bf16 causal: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) | {gpu}")
    return row


def main() -> int:
    gpu = phase_device()
    phase_build()
    main_err = phase_kernel_cases()
    phase_parity()
    launches = phase_serve(gpu)
    phase_breakdown(gpu)
    row = phase_timing(gpu, launches, main_err)
    print(json.dumps({"kernels": [row]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

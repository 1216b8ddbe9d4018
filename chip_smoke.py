#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Ten serving paths and their kernels: llama3.2-1b, olmo-1b and
codeqwen1.5-7b (flash attention), rwkv6-1.6b (the WKV6 scan),
recurrentgemma-9b (flash attention with a sliding window on its LOCAL
layers, the RG-LRU scan on its RGLRU layers), gemma2-9b (flash attention
with softcap 50, and a sliding window on its LOCAL layers), whisper-small
(flash attention without a causal mask over 1500 frames in its encoder,
causal in its decoder's self-attention; cross-attention plain) and
llama-3.2-vision-11b (flash attention in its 32 ATTN layers; its 8 gated
XATTN layers attend to 1601 patch embeddings in plain torch), mixtral-8x22b
and dbrx-132b (flash attention with 48 query heads over 8 KV heads of 128;
the MoE layer's dense path in plain torch), served at full width with their
depth cut to fit one card (``SERVE_DEPTH``).  Every path decodes through
one captured CUDA graph a step (``DecodeGraph``).
Phases, each printing its own lines, any failure ending the run non-zero:
  1. device  — fail without CUDA; print the card's name and power limit;
               TF32 off for f32 matmuls and convolutions.
  2. build   — compile every CUDA kernel from the repository's sources, all
               nvcc processes at once; print ptxas's registers, shared
               memory, spills and performance notes for each kernel.
  3. kernels — each kernel against its plain PyTorch version on the card
               (flash: bf16 on the wgmma kernel, f32 on the CUDA-core one).
  4. parity  — each smoke-width model in f32: CPU (plain) against CUDA (kernel),
               then the same decode steps captured and replayed against both
               (whisper and llama-vision with a seeded frontend and their
               XATTN gates drawn non-zero: at their initial zero the layer
               adds nothing); the MoE models' forward logits and aux loss too.
  5. serve   — each full-width model through ``repro_torch.launch.serve.run``,
               every launch count set to 0 just before and read just after:
               each layer's kernel launched once, no other kernel, no plain
               version on the card.  Then recurrentgemma-9b once more at a
               prompt of 2560, so that its 2048 window binds and every LOCAL
               layer's cache is a ring, decoded by replays over the wrapped rings.
  6. breakdown — the same serve calls again: every run's prefill and decode
               wall time, then one run under torch.profiler split by serve's
               own ``prefill`` / ``decode`` spans: device busy time, idle
               share, device operations and the largest kernels per phase;
               for the replayed decode steps, the host's launch calls a step.
  7. timing  — each kernel at its serving path's shape, beside its plain
               version, one PyTorch library call where there is one, and the
               card's bound; flash also on its f32 route at llama's shape;
               WKV6's two CUDA kernels each under torch.profiler (in phase 3).
  8. train   — each kernel wrapper refuses CUDA inputs that require grad;
               the ten archs' ``train_step`` at smoke width in f32, card
               against CPU over three steps (kernels off, as the reference
               trains); llama3.2-1b at full width in bf16 through
               ``repro_torch.launch.train.run`` in two settings (train.py's
               defaults, and S=2048 in four microbatches): the loss falls,
               no kernel launches, step wall, tokens/s, ``mfu``, peak memory,
               and one step under torch.profiler.
  9. fit     — the paper's measure -> fit -> register -> plan loop through
               ``repro_torch.core`` on the card: the host -> device copy
               (``bench_host_device_roundtrip``) and the other copy tiers one
               card has (host -> device pinned, device -> host pinned and
               pageable, device -> device) timed and fitted to postal models,
               each beside the registry's summit and gh200 copy tiers; the
               host -> device fit registered as ``h100_fitted``, which must
               plan ``gpudirect``; its fit residuals and drift summary.
 10. drills  — serve's per-step planner consult and its failure drills (run
               before phase 9, which then starts from the registry's
               built-in machines and a fresh link-health monitor):
               llama3.2-1b at full width through ``serve.run`` three times
               after a warm run (the replayed step's wall with the consult
               on, the consult's host time, 16 flash launches a request);
               the degradation drill with a host loss shed (the batch cut
               to 3 and the step captured again) and shrunk; the same
               drills at smoke width in f32, card against CPU (the same
               drill lines and planner counters, the shed rows equal to
               the unshed run's); and a seeded scenario, card against CPU.
 11. collectives — ``repro_torch.comms`` across four ranks on the one card
               (``launch.mesh.run_world``; gloo, since NCCL takes one rank
               a device): (a) the route table; (b) every wrapper and
               ``*_inner`` at the reference's check shapes on meshes
               (2, 2) and (1, 4), the card world against a host world;
               (c) the whole f32 gradient of llama3.2-1b at full width and
               depth 2, rank r giving (r + 1) g, reduced in 20 chunks of
               about 77 MB by flat, hierarchical, ring (on
               (1, 4): it reduces one axis) and auto, each exactly 10 g,
               with its wall, rate and peak memory; (d) each strategy timed
               at 4 KiB to 64 MiB a rank and fitted to α and β,
               ``bench_allreduce``, and ``measured_autotune`` at 1 and 64
               MiB beside the model's pick; (e) NCCL at world 1, each
               strategy returning its input.
 12. ranks   — the model across gloo ranks on the one card: (a)
               mixtral-8x22b at full width and serve depth over 8 expert
               ranks (``serve.run`` with mesh (1, 8): each rank draws its
               expert, runs flash in its prefill and every decode step
               eagerly), held to the dense path's run of the same weights
               (tokens, logits within 0.1 while the fed tokens agree,
               prefill's routes), with the walls, each layer's all-to-all
               spans, flash launches and peak memory of each rank;
               (b) llama3.2-1b at full width and depth 4 trained 3 steps
               (B=8 S=128) over a (2, 2) world, its compute split over
               "model" (``sharding.tp``), with each step's gather, forward
               and backward, model collectives, gradient reduce and update
               seconds and each kind of collective's calls and bytes a
               step; then, in the same world, rwkv6-1.6b at full width and
               depth 4 the same way (B=4 S=128, 2 steps, its time-mix and
               channel-mix split) and recurrentgemma-9b at full width and
               depth 5 (B=4 S=128, 2 steps, its RG-LRU block split on the
               rank's channels), each first loss within 2e-2 of one
               device's (``launch.train.run``) on the same weights and
               batch; (c) the
               CPU tests' world programs (expert-parallel cases, sharded
               train steps, llama-vision's, rwkv's and griffin's among them,
               and ZeRO-1's moments over "pod" x "data" on (2, 2, 2) and
               ``--no-fsdp``'s over "data", with rank 0's moment bytes)
               at smoke width, a card world against a host world (each
               program pair in one world a device, the two worlds at once);
               (d) in 12(b)'s world, after its legs, the dry-run's serving
               decode at batch 1 (``dryrun.serving_steps``, the weights'
               FSDP blocks and the KV caches' sequence chunks over "data")
               for gemma2-9b at full width and depth 4 in f32, 3 steps
               against caches of 65536 drawn from a seed (writes in both
               data ranks' chunks, the LOCAL ring wrapping), its tokens one
               device's and its logits within 1e-3, with each rank's step
               walls, collectives a step, cache bytes and peak memory.
 13. recovery — (a) llama3.2-1b at full width and depth 2 trained under
               ``runtime.run_with_recovery`` through an injected fault and a
               host loss (``shrink_and_replan``, a seeded backoff), its final
               parameters and moments bitwise an uninterrupted run's (else
               again in a new process with deterministic algorithms, and the
               leaves that differ named), with the checkpoint's size, the
               saves' and restores' seconds and peak memory; (b) the same
               model re-scaled over gloo worlds on the card, 4 -> 2 -> 4
               ranks, a checkpoint the hand-off (``runtime.checks``): each
               restored block bit for bit the saved tree's, each loss within
               2e-2 and the final parameters within 0.15 of the
               uninterrupted world's, with each world's step walls, restore
               seconds and peak memory a rank; (c) ``host_drop_drill``'s
               evidence equal to the CPU's; (d) serve's degradation and shed
               drills on mesh (2, 1) at full width: phase 10's drill lines,
               the unshed rows of the run without drills, the eager steps.
 14. dryrun  — the dry-run and the cost counter: ``python -m
               repro_torch.launch.dryrun`` on llama3.2-1b's, rwkv6-1.6b's
               and recurrentgemma-9b's ``decode_32k`` ``single`` and
               gemma2-9b's and recurrentgemma-9b's ``long_500k`` ``single``
               in a child process, started beside phase 2's build (a
               fake world of 256 ranks on meta tensors; this machine has no
               JAX), each record's compute (the per-rank dot FLOPs of the
               products split over "model", and at ``long_500k``'s batch of
               1 over "data" too, within 1% of the reference's),
               collectives, memory and ICI/DCN bytes; the counter over one
               full-width llama3.2-1b prefill on the card (B=4, prompt
               512, bf16, kernels off), its matmul FLOPs within 1% of
               torch.profiler's own estimate for the same call, both beside
               2·N·tokens; and the counter refusing the same prefill with
               the kernels on (their work is invisible to it).
The second-to-last line is the card as nvidia-smi names it, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# torch.compile (phase 7's library yardstick for softcap attention) builds in
# the checkout's kernel build directory, in this process, starting no workers
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      str(ROOT / "src" / "repro_torch" / "kernels" / "_build" / "inductor"))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(ROOT / "src"))

# Published peaks (NVIDIA data sheets, SXM parts, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s.  f32 inputs are bounded by the 67 TFLOP/s of the
# CUDA cores.
PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}
F32_FLOPS = 67e12
# about 10 ms of the card's clock: time for the host to enqueue a timing's calls
HOST_LEAD_CYCLES = 20_000_000
# f32: the kernel sums in another order; bf16: well above the rounding of
# bf16 outputs (about 4e-3 at these magnitudes), well below the outputs' size
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
B_SERVE, P_SERVE, N_SERVE = 4, 512, 32
ARCHS = ("llama3.2-1b", "rwkv6-1.6b", "recurrentgemma-9b", "olmo-1b", "codeqwen1.5-7b",
         "gemma2-9b", "whisper-small", "llama-3.2-vision-11b", "mixtral-8x22b", "dbrx-132b")
# layers served of the models that do not fit one card at full depth: full
# width, the group's count cut (about 40 GB of bf16 weights each, of 281
# and 263 GB)
SERVE_DEPTH = {"mixtral-8x22b": 8, "dbrx-132b": 6}
# each layer kind's prefill kernel (row name; XATTN layers launch none, and
# each encoder layer launches flash); decode launches none
KIND_KERNEL = {"attn": "flash_attention", "local": "flash_attention",
               "attn_x": "flash_attention", "xattn": None,
               "rwkv": "wkv6", "rglru": "rglru_scan"}
# each kernel's names in the profiler: the CUDA kernels that each run once a
# launch (WKV6's entry point launches two)
PROFILER_NAME = {"flash_attention": ("flash_fwd",),
                 "wkv6": ("wkv6_intra_kernel", "wkv6_state_kernel"),
                 "rglru_scan": ("rglru_scan_kernel",)}
# warm serve runs of the breakdown phase (cut from 5, 3 and 2 when phase 13
# came, to keep the script's wall inside its limit)
WARM_RUNS = {"llama3.2-1b": 3, "rwkv6-1.6b": 2, "recurrentgemma-9b": 1, "olmo-1b": 1,
             "codeqwen1.5-7b": 1, "gemma2-9b": 1, "whisper-small": 1,
             "llama-3.2-vision-11b": 1, "mixtral-8x22b": 1, "dbrx-132b": 1}
# the host's calls that launch device work, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# profiler sessions allowed for one profile: torch.profiler may drop events
PROFILE_TRIES = 3
# the ring run: one sequence whose prompt overruns recurrentgemma's window
RING_ARCH, P_RING, N_RING = "recurrentgemma-9b", 2560, 16
# phase 8: smoke-width train steps, card against CPU (warmup 1: all but the
# first move the weights); full-width training of one arch in two settings,
# (label, B, S, microbatches, steps, warmup steps): launch/train.py's own
# defaults, and a sequence of 2048 in four microbatches; model FLOPs share
# against the bf16 tensor-core peak
TRAIN_PARITY_STEPS = 3
TRAIN_ARCH = "llama3.2-1b"
TRAIN_SETTINGS = [("train.py defaults", 8, 128, 1, 5, 10),
                  ("S=2048, 4 microbatches", 8, 2048, 4, 3, 1)]
MFU_PEAK = 989e12
# train_step's spans (models/steps.py), which the profiler also records as
# device-side ranges
TRAIN_SPANS = ("train.grads", "train.update")
# phase 9: the fitted card's registry name; the registry's machines whose
# copy tiers (paper Table II, and a representative GH200) the card's stand beside
FIT_NAME = "h100_fitted"
FIT_COMPARE = ("summit", "gh200")
# the sizes of the copy on the card: bench_transfer's up to 16 MiB, which
# the card copies in a few microseconds, under the ~20 us a synchronise
# takes, and on to 1 GiB, where the bytes and not the synchronise set the
# time and beta is resolved
D2D_SIZES = tuple(1 << j for j in (10, 13, 16, 19, 22, 24, 26, 28, 30))
# phase 10: the arch served with the drills; the runs after the warm one;
# the degradation and host-loss steps; the seeded scenario's arguments
# (runtime.scenarios.generate); the smoke-width runs' shape; the metric
# families whose values the card must share with the CPU; serve's drill lines
DRILL_ARCH, DRILL_RUNS = "llama3.2-1b", 3
DEGRADE_AT, FAIL_AT = 8, 16
SCENARIO_ARGS = dict(seed=3, total_steps=12, hosts=4, n_events=4, tiers=("dcn",))
DRILL_SMOKE = dict(batch=4, prompt_len=16, new_tokens=24)
SHARED_METRICS = ("plan_cache.", "lowering_memo.", "engine.", "health.", "runtime.",
                  "serve.decode.tokens", "serve.batch.live", "serve.simulated_makespan_s")
DRILL_LINE = re.compile(r"^\[serve\] (link|host|scenario|per-step plan)")
# phase 11: the collectives' world on the card (gloo: NCCL takes one rank a
# device); the f32 gradient of llama3.2-1b at full width with COLL_LAYERS of
# its 16 layers (1.537 GB; the whole model's 4.943 GB took 35-45 s of the
# phase in its four reductions) reduced in chunks of equal size, all of
# them, about 77 MB each as the whole model's 64 were; the strategies timed
# at 4 KiB to 64 MiB a rank, 4x apart, and measured_autotune at two sizes; a
# world's limit in seconds
COLL_WORLD, COLL_CHUNKS, COLL_LAYERS = 4, 20, 2
# phase 12: the model across gloo ranks on the one card
EP_ARCH, EP_MESH, EP_RANKS = "mixtral-8x22b", "1,8", 8
# capacity factor E / top_k: a slice's capacity is then its own size, so no
# token can be dropped and the expert-parallel layer computes the dense one
EP_CF = 4.0
# test_torch_serve.py's mixtral bf16 bound (its distance to the f32 logits).
# On the card the two paths' expert products are GEMMs of other shapes and
# round apart by a bf16 ulp now and then; a router near-tie then picks
# another expert for a token (0.5% of prefill's routes from layer 3 on),
# which moves that position's logits by O(1).  So the bound holds the
# median position, the routes must agree at the serve test's 95%, and a
# generated token may differ only at a near-tie of the dense logits.
EP_TOL = 0.1
EP_ROUTES = 0.95
SHARD_MESH, SHARD_RANKS, SHARD_STEPS, SHARD_WARMUP = "2,2", 4, 3, 1
SHARD_LOSS_TOL = 2e-2  # the reference's (tests/_multidevice_checks.py:164)
# 12(c)'s sharded train cases on the card (each splits its compute over
# "model"; the CPU tests run every case of sharding.checks.TRAIN_CASES)
CARD_TRAIN_CASES = ["f32", "f32_microbatches", "f32_batch_3", "bf16", "vision_f32",
                    "rwkv_f32", "griffin_f32", "f32_zero1_pod", "f32_no_fsdp"]
# the default layout and the moments on their own FSDP axes (ZeRO-1 over
# "pod" on (2, 2, 2), and --no-fsdp), whose moment bytes a rank 12(c) prints
MOMENT_CASES = ("f32", "f32_zero1_pod", "f32_no_fsdp")
# 12(b)'s RWKV and griffin legs over the same (2, 2) world, B=4 S=128, 2
# steps: rwkv6-1.6b at full width, its time-mix and channel-mix split over
# "model" (32 heads, 2 a rank); recurrentgemma-9b at full width with one
# group of each pattern, (RGLRU, RGLRU, LOCAL) x 1 and (RGLRU, RGLRU) x 1
# (2.06 G parameters, 1.05 G of them the tied embedding; the 9 B model's
# weights and moments, about 90 GB, do not fit four ranks on one card),
# its RG-LRU block on the rank's 2048 of 4096 channels
RWKV_TRAIN_ARCH, GRIFFIN_TRAIN_ARCH = "rwkv6-1.6b", "recurrentgemma-9b"
LEG_B, LEG_S, LEG_STEPS = 4, 128, 2
# 12(b)'s llama3.2-1b and rwkv6-1.6b legs: full width, 4 of their 16 and 24
# layers (0.506 G and 0.488 G parameters), for the script's wall
LEG_LAYERS = 4
# 12(d), in 12(b)'s world: the dry-run's serving decode at batch 1
# (``dryrun.serving_steps``: the weights' FSDP blocks and the KV caches'
# sequence chunks over "data", as the reference's GSPMD splits long_500k)
# for gemma2-9b at full width with 2 of its 21 (LOCAL, ATTN) groups (1.71 G
# parameters, 0.92 G of them the tied table), f32, 3 steps against caches of
# 65536 drawn from a seed with positions 0 .. 32766 written: step 0 writes
# the last slot of data rank 0's chunk of the global caches, step 1 the
# first of rank 1's, and the LOCAL ring of 4096 wraps from slot 4095 (rank
# 1) to slot 0 (rank 0).  One device's decode_step on the same weights and
# caches is the reference: tokens equal, logits within DECODE_TOL of their
# largest magnitude
DECODE_ARCH, DECODE_GROUPS, DECODE_CAP, DECODE_WRITTEN, DECODE_STEPS = (
    "gemma2-9b", 2, 65536, 32767, 3)
DECODE_TOL = 1e-3
RANKS_TIMEOUT = 900.0
COLL_FIT_SIZES = tuple(4096 * 4 ** j for j in range(8))
COLL_AUTOTUNE_SIZES = (1 << 20, 1 << 26)
COLL_TIMEOUT = 900.0
# phase 13: recovery and elastic re-scale, llama3.2-1b at full width with
# REC_LAYERS of its 16 layers (0.384 G parameters, 0.263 G of them the tied
# table; a checkpoint of 3.84 GB: at full depth its 12.4 GB took most of
# the phase's wall in disk writes and reads).  (a) under run_with_recovery: B=8 S=128, 8 steps, a checkpoint every 3, an
# InjectedFault at step 4 and a HostLost at step 7 (routed through
# shrink_and_replan on a 12-rank machine derived from summit, with a seeded
# backoff); (b) the 4 -> 2 -> 4 rank re-scale through three gloo worlds on
# the card, each loss and the final parameters held to the uninterrupted
# world at the reference's bounds; (c) host_drop_drill's evidence, the CPU's
# (its sha256 over the sorted JSON, and its decision fields); (d) serve's
# drills on mesh (2, 1) at full width
REC_STEPS, REC_EVERY, REC_B, REC_S, REC_WARMUP = 8, 3, 8, 128, 10
REC_LAYERS = 2
REC_FAULTS = {4: "InjectedFault", 7: "HostLost"}
REC_MACHINE, REC_LOST_HOST = "h100_recovery", 11
RESCALE_MESHES = ((2, 2), (2, 1), (2, 2))
RESCALE_LOSS, RESCALE_PARAMS = 2e-2, 0.15  # tests/_multidevice_checks.py:225, 236, 243
RESCALE_TIMEOUT = 900.0
CKPT_GB = 12.0  # the most checkpoint bytes on disk at once: three of 3.84 GB in (a)
DRILL_EVIDENCE_SHA = "dcd1fb67d493d9e84e0a153224d5eedf735b6045f1f26e5ccf31ef51d309f5f2"
DRILL_EVIDENCE = {"stale_pick": "node_aware_alltoall", "fresh_pick": "bruck_alltoall",
                  "survivors": 8, "generations_bumped": 4, "des_overrides": 40,
                  "t_stale_on_shrunk": 4.939523199999999e-05,
                  "t_fresh_on_shrunk": 4.4961024e-05, "loss_continuity": True}
MESH_DRILL = "2,1"
# llama3.2-1b's replayed decode step wall before serve consulted the planner
# (PERF.md section 5, the same card at 700 W), ms
REPLAY_BEFORE_MS = (4.209, 4.229)


WKV_SHAPE = dict(B=4, S=512, H=32, K=64, chunk=32, dtype=torch.bfloat16)
# WKV6 against the token-by-token recurrence: f32 at 2e-4, the JAX package's
# own tolerance for its kernel against the same oracle (the chunked algebra
# sums in another order); bf16 y at 1e-2, above one rounding of a bf16
# output, while the state stays f32 and keeps 2e-4.
WKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
WKV_CASES = [
    # (label, B, S, H, K, chunk, dtype, log_w draw); the first three replay the
    # JAX package's kernel cases, the fourth its strong-decay case
    ("wkv_case0", 1, 64, 2, 64, 16, torch.float32, "exp_normal"),
    ("wkv_case1", 2, 128, 3, 64, 32, torch.float32, "exp_normal"),
    ("wkv_case2", 1, 96, 1, 32, 32, torch.float32, "exp_normal"),
    ("strong_decay", 1, 64, 1, 32, 16, torch.float32, "minus50"),
    ("ragged_s70", 2, 70, 2, 64, 32, torch.float32, "exp_normal"),
    ("ragged_s200", 2, 200, 4, 64, 32, torch.float32, "exp_normal"),
    ("bf16", 2, 256, 4, 64, 32, torch.bfloat16, "exp_normal"),
    ("strided_views", 2, 96, 4, 64, 32, torch.float32, "exp_normal"),
    ("model_decay_clipped", 2, 256, 4, 64, 32, torch.float32, "model_clipped"),
    ("main_path", 4, 512, 32, 64, 32, torch.bfloat16, "exp_normal"),
    ("main_path_f32", 4, 512, 32, 64, 32, torch.float32, "model_clipped"),
    ("s_below_chunk", 1, 20, 2, 64, 32, torch.float32, "exp_normal"),
    ("last_chunk_one_row", 2, 97, 3, 32, 32, torch.bfloat16, "exp_normal"),
]

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
    # recurrentgemma's LOCAL layers: 16 query heads over 1 KV head of 256
    ("gemma_main_path", 4, 16, 1, 512, 512, 256, torch.bfloat16, {"window": 2048}),
    ("gemma_window_binds", 1, 16, 1, 700, 700, 256, torch.bfloat16, {"window": 256}),
    ("gemma_window_binds_f32", 2, 4, 1, 300, 300, 256, torch.float32, {"window": 64}),
    ("gemma_ring_prompt", 1, 16, 1, 2560, 2560, 256, torch.bfloat16, {"window": 2048}),
    # the prefill shapes of olmo-1b and codeqwen1.5-7b (MHA at dh 128) and
    # gemma2-9b (16 query heads over 8 KV heads of 256, softcap 50 on every
    # layer, window 4096 on the LOCAL ones)
    ("olmo_main_path", 4, 16, 16, 512, 512, 128, torch.bfloat16, {}),
    ("codeqwen_main_path", 4, 32, 32, 512, 512, 128, torch.bfloat16, {}),
    ("gemma2_attn_main_path", 4, 16, 8, 512, 512, 256, torch.bfloat16, {"softcap": 50.0}),
    ("gemma2_local_main_path", 4, 16, 8, 512, 512, 256, torch.bfloat16,
     {"softcap": 50.0, "window": 4096}),
    ("gemma2_window_binds", 1, 16, 8, 700, 700, 256, torch.bfloat16,
     {"softcap": 50.0, "window": 256}),
    # whisper-small's encoder (1500 frames, no causal mask: the last of the
    # 128-row tiles holds 92 rows) and decoder (MHA 12 x 64), and
    # llama-3.2-vision-11b's ATTN layers (32 query heads over 8 KV heads of
    # 128); the f32 route without a causal mask at a ragged length
    ("whisper_encoder_main_path", 4, 12, 12, 1500, 1500, 64, torch.bfloat16, {"causal": False}),
    ("whisper_decoder_main_path", 4, 12, 12, 512, 512, 64, torch.bfloat16, {}),
    ("vision_main_path", 4, 32, 8, 512, 512, 128, torch.bfloat16, {}),
    ("noncausal_ragged_f32", 1, 4, 4, 1100, 1100, 64, torch.float32, {"causal": False}),
    # mixtral-8x22b's and dbrx-132b's prefill: 48 query heads over 8 KV heads
    # of 128, a group of 6 (mixtral's window of 4096 does not bind at 512;
    # here 256 does)
    ("moe_main_path", 4, 48, 8, 512, 512, 128, torch.bfloat16, {}),
    ("moe_f32", 1, 48, 8, 300, 300, 128, torch.float32, {}),
    ("moe_window_binds", 1, 48, 8, 700, 700, 128, torch.bfloat16, {"window": 256}),
    # the bf16 (wgmma) kernel: each head dim, ragged lengths, binding windows,
    # softcap, q_offset with Sq < Sk, one KV head, no causal mask, and q, k, v
    # cut from wider rows (a non-dense view; o comes back dense)
    ("bf16_dh32_ragged", 2, 4, 2, 200, 200, 32, torch.bfloat16, {}),
    ("bf16_dh64_ragged", 2, 4, 2, 333, 333, 64, torch.bfloat16, {}),
    ("bf16_dh128_ragged", 2, 8, 2, 200, 200, 128, torch.bfloat16, {}),
    ("bf16_dh256_window_binds", 1, 4, 2, 333, 333, 256, torch.bfloat16, {"window": 64}),
    ("bf16_softcap", 1, 2, 2, 128, 128, 64, torch.bfloat16, {"softcap": 20.0}),
    ("bf16_dh256_window_softcap", 1, 2, 2, 200, 200, 256, torch.bfloat16,
     {"window": 32, "softcap": 10.0}),
    ("bf16_q_offset_ragged", 2, 4, 1, 37, 301, 64, torch.bfloat16, {"q_offset": 264}),
    ("bf16_q_offset_dh256_window", 1, 16, 1, 100, 612, 256, torch.bfloat16,
     {"q_offset": 512, "window": 256}),
    ("bf16_mqa_h16", 2, 16, 1, 256, 256, 64, torch.bfloat16, {}),
    ("bf16_noncausal_dh128", 2, 2, 2, 192, 192, 128, torch.bfloat16, {"causal": False}),
    ("bf16_noncausal_window_dh32", 1, 4, 4, 300, 300, 32, torch.bfloat16,
     {"causal": False, "window": 40}),
    ("bf16_strided_views", 2, 4, 2, 160, 160, 64, torch.bfloat16, {"window": 48}),
]
# each serving path's flash shape in prefill (B=4, bf16; S=512 causal in the
# decoders, 1500 frames without a causal mask in whisper's encoder):
# (arch, or archs of one shape, its case in FLASH_CASES, part, H, G, S, dh,
# kwargs).  No window binds at 512, so gemma2's LOCAL layers do the work of
# its ATTN ones, and mixtral's LOCAL layers that of dbrx's ATTN ones: one
# timing for each pair
FA_B, FA_S = 4, 512
FA_PATHS = [
    ("llama3.2-1b", "main_path", "decoder", 32, 8, FA_S, 64, {}),
    ("recurrentgemma-9b", "gemma_main_path", "decoder", 16, 1, FA_S, 256, {"window": 2048}),
    ("olmo-1b", "olmo_main_path", "decoder", 16, 16, FA_S, 128, {}),
    ("codeqwen1.5-7b", "codeqwen_main_path", "decoder", 32, 32, FA_S, 128, {}),
    ("gemma2-9b", "gemma2_attn_main_path", "decoder", 16, 8, FA_S, 256, {"softcap": 50.0}),
    ("whisper-small", "whisper_encoder_main_path", "encoder", 12, 12, 1500, 64,
     {"causal": False}),
    ("whisper-small", "whisper_decoder_main_path", "decoder", 12, 12, FA_S, 64, {}),
    ("llama-3.2-vision-11b", "vision_main_path", "decoder", 32, 8, FA_S, 128, {}),
    (("mixtral-8x22b", "dbrx-132b"), "moe_main_path", "decoder", 48, 8, FA_S, 128, {}),
]

LRU_SHAPE = dict(B=4, S=512, W=4096, dtype=torch.float32)
# the JAX package's own tolerances for its kernel against the same oracle
LRU_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4), torch.bfloat16: dict(atol=0.15, rtol=0.1)}
LRU_CASES = [
    # (label, B, S, W, dtype, draw); the first four replay the JAX package's
    # kernel cases: a uniform in [0.3, 0.999) (bf16: [0.5, 0.99)), b normal
    ("lru_case0", 1, 128, 128, torch.float32, "uniform"),
    ("lru_case1", 2, 256, 256, torch.float32, "uniform"),
    ("lru_case2", 1, 64, 512, torch.float32, "uniform"),
    ("lru_bf16", 1, 128, 128, torch.bfloat16, "uniform_bf16"),
    ("ragged_s200_w96", 2, 200, 96, torch.float32, "uniform"),
    ("ragged_s70_w4100", 1, 70, 4100, torch.float32, "uniform"),
    ("strided_views", 2, 96, 256, torch.float32, "uniform"),
    ("bf16_model", 2, 512, 4096, torch.bfloat16, "model"),
    ("model_draw", 2, 300, 4096, torch.float32, "model"),
    ("main_path", 4, 512, 4096, torch.float32, "model"),
    ("ring_prompt", 1, 2560, 4096, torch.float32, "model"),
]


def serve_config(arch: str):
    """The config a serve run takes: the published one, with the layer
    group's count cut to ``SERVE_DEPTH`` where the arch has one (the name
    then ``<arch>-depth<k>``)."""
    from repro_torch.configs import LayerGroup, get_config

    cfg = get_config(arch)
    if arch not in SERVE_DEPTH:
        return cfg
    (group,) = cfg.groups
    k = SERVE_DEPTH[arch]
    return dataclasses.replace(cfg, name=f"{arch}-depth{k}",
                               groups=(LayerGroup(group.pattern, k),))


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
    ``iters`` back-to-back calls each, after a warm-up.  Before each timing
    the stream first sleeps for HOST_LEAD_CYCLES, so that the host enqueues
    the ``iters`` calls while the device waits, and the events time the
    device work alone even where a call's host work (a wrapper's checks,
    allocations and ctypes call) is longer than its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def agrees(out: torch.Tensor, ref: torch.Tensor, tol: float) -> bool:
    """Attention's gate: ``out`` finite and within ``tol + tol * |ref|`` of ``ref``."""
    d = (out.float() - ref.float()).abs()
    return not bool((d > tol + tol * ref.float().abs()).any()) and bool(torch.isfinite(out).all())


def model_layout(rng, B, H, G, Sq, Sk, dh, dtype, device="cuda", strided=False):
    """q (B, Sq, H, dh), k, v (B, Sk, G, dh) as the model makes them;
    ``strided`` cuts each from rows twice as wide (a non-dense view)."""
    def mk(*shape):
        wide = (*shape[:-1], 2 * shape[-1]) if strided else shape
        t = torch.from_numpy(rng.standard_normal(wide, dtype=np.float32)).to(device, dtype)
        return t[..., :shape[-1]]
    return mk(B, Sq, H, dh), mk(B, Sk, G, dh), mk(B, Sk, G, dh)


def wkv_inputs(rng, B, S, H, K, dtype, draw, strided=False, device="cuda"):
    """r, k, v (B, S, H, K) in ``dtype``, log_w in f32 and u (H, K) in f32,
    as the model passes them.  log_w is -exp(N(0, 1)) as the JAX package's
    kernel tests draw it ("exp_normal"), -50 with u = 0 as its strong-decay
    test ("minus50"), or as the model makes it, -exp(clip(w0 + z, -8, 8))
    with w0 = -1 and z spread wide enough that both clips are reached
    ("model_clipped": steps of -e^8 = -2981 beside steps of -3.4e-4).
    ``strided`` hands the kernel views: r, k, v cut from wider rows, log_w a
    transposed (B, H, S, K) buffer."""
    def mk(scale=1.0):
        a = rng.standard_normal((B, S, H, K), dtype=np.float32) * scale
        return torch.from_numpy(a).to(device)

    r, k, v = mk(), mk(0.5), mk()
    u = torch.from_numpy(rng.standard_normal((H, K), dtype=np.float32) * 0.1).to(device)
    if draw == "exp_normal":
        log_w = -torch.exp(mk())
    elif draw == "minus50":
        log_w, u = torch.full((B, S, H, K), -50.0, device=device), torch.zeros_like(u)
    else:
        log_w = -torch.exp(torch.clamp(-1.0 + mk(4.0), -8.0, 8.0))
    r, k, v = (t.to(dtype) for t in (r, k, v))
    if strided:
        def widen(t):
            buf = torch.zeros((B, S, H, 2 * K), dtype=t.dtype, device=device)
            buf[..., :K] = t
            return buf[..., :K]

        r, k, v = map(widen, (r, k, v))
        log_w = log_w.transpose(1, 2).contiguous().transpose(1, 2)
    return r, k, v, log_w, u


def lru_inputs(rng, B, S, W, dtype, draw, strided=False, device="cuda"):
    """a, b (B, S, W) in ``dtype``.  "uniform": a in [0.3, 0.999) and b normal,
    as the JAX package's kernel tests draw them ("uniform_bf16": a in [0.5,
    0.99)); "model": a and b from the port's ``griffin._gates`` on normal u,
    with gate weights drawn at the model's std and Lambda from 2 to 6, so the
    decays reach about e^-48.  ``strided`` hands the kernel views cut from
    wider rows and from a batch-major buffer with a gap between sequences."""
    from repro_torch.models import griffin

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    b = mk(B, S, W)
    if draw == "model":
        bw = W // griffin.N_BLOCKS
        p = {"gate_a": mk(griffin.N_BLOCKS, bw, bw) / bw ** 0.5,
             "gate_x": mk(griffin.N_BLOCKS, bw, bw) / bw ** 0.5,
             "lam": torch.linspace(2.0, 6.0, W, device=device)}
        a, b = griffin._gates(p, b)
    else:
        lo, hi = (0.5, 0.99) if draw == "uniform_bf16" else (0.3, 0.999)
        a = torch.from_numpy(rng.uniform(lo, hi, (B, S, W)).astype(np.float32)).to(device)
    a, b = a.to(dtype), b.to(dtype)
    if strided:
        wide = torch.ones((B, S + 3, 2 * W), dtype=dtype, device=device)
        wide[:, :S, :W] = a
        a = wide[:, :S, :W]
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    return a, b


def kernel_modules() -> dict:
    """Row name -> (kernel wrapper module, ops module) of every kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import kernel as lru_kernel
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops

    return {"flash_attention": (fa_kernel, fa_ops), "wkv6": (wkv_kernel, wkv_ops),
            "rglru_scan": (lru_kernel, lru_ops)}


def prefill_launches(cfg) -> dict:
    """Row name -> launches of that kernel in one prefill of ``cfg``: one for
    each layer whose kind it serves, and flash once for each encoder layer."""
    want = {name: 0 for name in kernel_modules()}
    want["flash_attention"] += cfg.encoder_layers
    for g in cfg.groups:
        for kind in g.pattern:
            if KIND_KERNEL[kind]:
                want[KIND_KERNEL[kind]] += g.count
    return want


def zero_counts() -> None:
    for kern, ops in kernel_modules().values():
        kern.launches = 0
        ops.plain_calls = 0


def read_counts() -> dict:
    """Row name -> (kernel launches, plain-version calls)."""
    return {name: (kern.launches, ops.plain_calls)
            for name, (kern, ops) in kernel_modules().items()}


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
        entry = ""
        for ln in build.build_log(name).splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]  # mangled: the template arguments tell kernels apart
            elif "registers" in ln or "spill" in ln or "C75" in ln:
                say("build", f"{name} {entry}: {ln.replace('ptxas info    :', '').strip()}")


def phase_kernel_cases() -> dict:
    """Flash kernel against attention_ref on the same CUDA tensors; returns
    the max abs error at each serving path's shape (by case label)."""
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(0)
    errs = {}
    for label, B, H, G, Sq, Sk, dh, dtype, kw in FA_CASES:
        q, k, v = model_layout(rng, B, H, G, Sq, Sk, dh, dtype,
                               strided=label == "bf16_strided_views")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = kernel.flash_attention(qt, kt, vt, **kw)
        ref = attention_ref(qt, kt, vt, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dtype]
        ok = agrees(out, ref, tol)
        say("kernels", f"{label}: B={B} H={H} G={G} Sq={Sq} Sk={Sk} dh={dh} "
                       f"{str(dtype)[6:]} {kw} max_abs_err={err:.3e} tol={tol:g} "
                       f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with attention_ref in {label}")
        if label.endswith("main_path"):  # a serving path's shape
            errs[label] = err
            # the model-layout entry point the serve path calls
            o2 = ops.attention(q, k, v, **kw)
            if not torch.equal(o2, out.transpose(1, 2)):
                raise AssertionError("ops.attention differs from the kernel it wraps")
    return errs


def phase_wkv_cases() -> tuple:
    """WKV6 kernel against wkv6_ref (the token-by-token recurrence) on the
    same CUDA tensors, y and the final state.  Returns y's max abs error at
    the serving path's shape and the device ms of each of the entry point's
    two CUDA kernels at that shape (torch.profiler, here: before the serve
    phases run their own large profiles)."""
    from repro_torch.kernels.rwkv6 import kernel, ops
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.models.rwkv import wkv_chunked

    rng = np.random.default_rng(0)
    main_err = None
    for label, B, S, H, K, chunk, dtype, draw in WKV_CASES:
        r, k, v, log_w, u = wkv_inputs(rng, B, S, H, K, dtype, draw,
                                       strided=label == "strided_views")
        y, state = kernel.wkv6(r, k, v, log_w, u, chunk=chunk)
        y_ref, state_ref = wkv6_ref(r, k, v, log_w, u)
        torch.cuda.synchronize()
        ok, errs = True, {}
        for name, got, want, tol in (("y", y, y_ref, WKV_TOL[dtype]),
                                     ("state", state, state_ref, WKV_TOL[torch.float32])):
            diff = (got.float() - want.float()).abs()
            errs[name] = diff.max().item()
            ok = (ok and not bool((diff > tol + tol * want.float().abs()).any())
                  and bool(torch.isfinite(got).all()))
        say("kernels", f"wkv6 {label}: B={B} S={S} H={H} K={K} chunk={chunk} "
                       f"{str(dtype)[6:]} log_w {draw} ({log_w.min().item():.4g} .. "
                       f"{log_w.max().item():.3g}): y max_abs_err={errs['y']:.3e} "
                       f"tol={WKV_TOL[dtype]:g}, state max_abs_err={errs['state']:.3e} "
                       f"tol={WKV_TOL[torch.float32]:g} (|state| <= "
                       f"{state_ref.abs().max().item():.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"wkv6 disagrees with wkv6_ref in {label}")
        if draw == "model_clipped" and S <= 256:
            # the reference's chunked algebra (f32 cumulative sums, as in the
            # Pallas body) at the same draw, for comparison only
            yc, state_c = wkv_chunked(r.float(), k.float(), v.float(), log_w, u, chunk=chunk)
            say("kernels", f"wkv6 {label}: wkv_chunked (plain f32 cumulative sums) at the "
                           f"same draw: y max_abs_err={(yc - y_ref).abs().max().item():.3e}, "
                           f"state max_abs_err={(state_c - state_ref).abs().max().item():.3e}")
        if label == "main_path":
            main_err = errs["y"]
            y2, state2 = ops.wkv(r, k, v, log_w, u, chunk=chunk)  # the model's entry point
            if not (torch.equal(y2, y) and torch.equal(state2, state)):
                raise AssertionError("ops.wkv differs from the kernel it wraps")
    s = WKV_SHAPE
    r, k, v, log_w, u = wkv_inputs(np.random.default_rng(1), s["B"], s["S"], s["H"], s["K"],
                                   s["dtype"], "model_clipped")
    n_launch = kernel.launches
    parts, recorded = profiled_ms(lambda: kernel.wkv6(r, k, v, log_w, u, chunk=s["chunk"]),
                                  PROFILER_NAME["wkv6"])
    kernel.launches = n_launch  # timing launches are not the main path's
    say("kernels", f"wkv6 main_path shape under torch.profiler: "
                   f"{', '.join(f'{n} {t:.4f} ms' for n, t in parts.items())} a launch "
                   f"(launches recorded {recorded} of 20)")
    return main_err, parts


def phase_lru_cases() -> float:
    """RG-LRU kernel against rglru_ref (the sequential recurrence) on the
    same CUDA tensors; returns the max abs error at the serving path's
    shape."""
    from repro_torch.kernels.rglru import kernel, ops
    from repro_torch.kernels.rglru.ref import rglru_ref

    rng = np.random.default_rng(0)
    main_err = None
    for label, B, S, W, dtype, draw in LRU_CASES:
        a, b = lru_inputs(rng, B, S, W, dtype, draw, strided=label == "strided_views")
        y = kernel.rglru_scan(a, b)
        ref, _ = rglru_ref(a, b)
        torch.cuda.synchronize()
        tol = LRU_TOL[dtype]
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        bad = diff > tol["atol"] + tol["rtol"] * ref.float().abs()
        ok = y.dtype == dtype and not bool(bad.any()) and bool(torch.isfinite(y).all())
        L, C = kernel.chunking(S)
        say("kernels", f"rglru_scan {label}: B={B} S={S} W={W} {str(dtype)[6:]} a {draw} "
                       f"({a.float().min().item():.3g} .. {a.float().max().item():.4g}), chunks "
                       f"{C} x {L}: max_abs_err={err:.3e} tol={tol} (|h| <= "
                       f"{ref.float().abs().max().item():.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rglru_scan disagrees with rglru_ref in {label}")
        if label == "main_path":
            main_err = err
            if not torch.equal(ops.scan(a, b), y):  # the model's entry point
                raise AssertionError("ops.scan differs from the kernel it wraps")
    return main_err


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def nbytes(tree) -> int:
    """Bytes of a tree's tensors (a non-parametric norm's None holds none)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree) if t is not None)


def phase_parity(arch: str) -> None:
    """Smoke-width model in f32, one set of weights: prefill + decode on the
    CPU (plain versions) against CUDA (the kernels); logits and caches.  The
    prompt of 40 is longer than the smoke window of 32, so the window binds
    in the flash kernel and each LOCAL layer's cache is a ring.  Models with
    a frontend get one drawn from the seed, and their XATTN gates non-zero.
    Then the same decode steps once more from a copy of the CUDA prefill's
    caches, captured and replayed (``DecodeGraph``): logits, greedy tokens
    and caches against the eager CUDA steps and the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import use_kernels
    from repro_torch.models import decode as dec
    from repro_torch.models.convert import draw_xattn_gates, tree_map
    from repro_torch.models.transformer import forward, init_params

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    want = prefill_launches(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    B, P, N = 2, 40, 6
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(B, P))
    draw_xattn_gates(params, rng, torch.from_numpy)
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    fr = None
    if cfg.frontend_tokens:
        fr = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model), dtype=np.float32))
    use_kernels(True)
    try:
        tok_cpu = torch.from_numpy(prompts)
        lg_c, cache_c = dec.prefill(cfg, params, tok_cpu, frontend=fr, capacity=P + N)
        before = read_counts()
        lg_g, cache_g = dec.prefill(cfg, params_gpu, tok_cpu.cuda(),
                                    frontend=None if fr is None else fr.cuda(), capacity=P + N)
        launched = {name: c[0] - before[name][0] for name, c in read_counts().items()}
        worst = (lg_g.cpu() - lg_c).abs().max().item()
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=1e-4)
        forward_note = ""
        if cfg.is_moe:  # forward's logits and the routers' summed aux loss
            (fl_c, aux_c), (fl_g, aux_g) = (forward(cfg, p, t) for p, t in (
                (params, tok_cpu), (params_gpu, tok_cpu.cuda())))
            torch.testing.assert_close(fl_g.cpu(), fl_c, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(aux_g.cpu(), aux_c, atol=1e-4, rtol=1e-4)
            forward_note = (f"; forward logits {(fl_g.cpu() - fl_c).abs().max().item():.3e}, "
                            f"aux {aux_c.item():.6f} CPU, {aux_g.item():.6f} CUDA")
        steps = dec.DecodeGraph(cfg, params_gpu, tree_map(lambda t: t.clone(), cache_g),
                                lg_g.argmax(-1)[:, None], P, N)
        fed, replay_worst = [], {"eager CUDA": 0.0, "CPU": 0.0}
        for i in range(N):
            tok = lg_c.argmax(-1)[:, None]  # both sides decode the CPU's pick
            fed.append(tok[:, 0])
            lg_c, cache_c = dec.decode_step(cfg, params, cache_c, tok, P + i)
            lg_g, cache_g = dec.decode_step(cfg, params_gpu, cache_g, tok.cuda(), P + i)
            lg_r = steps.step().cpu()  # the replay decodes its own pick
            worst = max(worst, (lg_g.cpu() - lg_c).abs().max().item())
            torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=1e-4)
            for side, ref in (("eager CUDA", lg_g.cpu()), ("CPU", lg_c)):
                replay_worst[side] = max(replay_worst[side], (lg_r - ref).abs().max().item())
                torch.testing.assert_close(lg_r, ref, atol=1e-4, rtol=1e-4)
        if steps.graph is None or not torch.equal(steps.tokens.cpu(), torch.stack(fed, dim=1)):
            raise AssertionError(f"{cfg.name}: the replayed decode was not captured or "
                                 "decoded other tokens than the CPU")
        cache_worst = 0.0
        for c, g, r in zip(_leaves(cache_c), _leaves(cache_g), _leaves(steps.caches)):
            torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(r, g, atol=1e-4, rtol=1e-4)
            cache_worst = max(cache_worst, (g.cpu().double() - c.double()).abs().max().item(),
                              (r.double() - g.double()).abs().max().item())
    finally:
        use_kernels(False)
    if launched != want:
        raise AssertionError(f"CUDA prefill launched {launched}, expected {want}")
    say("parity", f"{cfg.name} f32 B={B} prompt={P}: prefill + {N} decode steps, "
                  f"CUDA vs CPU logits max abs diff {worst:.3e}; decode captured and "
                  f"replayed ({N - 1} replays) vs eager CUDA {replay_worst['eager CUDA']:.3e}, "
                  f"vs CPU {replay_worst['CPU']:.3e}; caches {cache_worst:.3e} (tol 1e-4), "
                  f"launches in the CUDA prefill {launched}{forward_note}")


def serve_once(arch: str, quiet: bool) -> tuple:
    """One ``serve.run`` of ``arch``'s ``serve_config`` (full width): (generations,
    prefill and decode wall seconds, and the seconds of decode's first step,
    its eager warm-up and the capture, from serve's own metrics).  Fails
    unless serve captured its decode step."""
    from repro_torch.launch import serve
    from repro_torch.obs import metrics

    hist = [metrics.registry().histogram(f"serve.{k}.seconds")
            for k in ("prefill", "decode", "decode.first_step")]
    before = [(h.count, h.total) for h in hist]
    with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
        gen = serve.run(serve_config(arch), batch=B_SERVE, prompt_len=P_SERVE,
                        new_tokens=N_SERVE, seed=0, device="cuda")
    if hist[2].count != before[2][0] + 1:
        raise AssertionError(f"{arch} serve: decode was not captured as a CUDA graph")
    return (gen, *(h.total - b for h, (_, b) in zip(hist, before)))


def check_counts(what: str, counts: dict, want: dict) -> None:
    """Every kernel launched as often as ``want`` says and no call took a
    plain version on the card."""
    for name, (launched, plain) in counts.items():
        if launched != want[name]:
            raise AssertionError(f"{what} launched {name} {launched} times, "
                                 f"expected {want[name]}")
        if plain:
            raise AssertionError(f"{what}: {plain} {name} calls took the plain "
                                 "version on the card")


def phase_serve(gpu: str, arch: str) -> tuple:
    """Full-width serve of ``arch`` (at ``SERVE_DEPTH`` layers where it has
    one): every launch count is 0 just before and read just after; each
    layer's kernel launched once, every other kernel never, and no call took
    a plain version on the card.  The launches made inside the encoder
    (prefill's ``frontend_states``) are read apart in the same run: one flash
    launch for each encoder layer; so are the bytes of the weights serve
    draws, beside those of the model at its published depth.  Returns the
    launches of the kernels this path runs, and those of them made in the
    encoder."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode as dec

    cfg = serve_config(arch)
    want = prefill_launches(cfg)
    in_encoder = {name: 0 for name in want}
    states, init = dec.frontend_states, serve.init_params
    group_bytes, all_bytes = [], []

    def counted_states(*args, **kwargs):
        before = read_counts()
        out = states(*args, **kwargs)
        for name, c in read_counts().items():
            in_encoder[name] += c[0] - before[name][0]
        return out

    def counted_init(*args, **kwargs):
        params = init(*args, **kwargs)
        group_bytes.extend(nbytes(gp) for gp in params["groups"])
        all_bytes.append(nbytes(params))
        return params

    torch.cuda.empty_cache()  # the last arch's weights, freed, leave the card
    dec.frontend_states, serve.init_params = counted_states, counted_init
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        gen, t_pre, t_dec, t_first = serve_once(arch, quiet=False)
        counts = read_counts()
    finally:
        dec.frontend_states, serve.init_params = states, init
    peak = torch.cuda.max_memory_allocated()
    if gen.shape != (B_SERVE, N_SERVE) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"generations {gen.shape} out of range")
    check_counts(f"{arch} serve", counts, want)
    want_enc = {name: cfg.encoder_layers if name == "flash_attention" else 0 for name in want}
    if in_encoder != want_enc:
        raise AssertionError(f"{arch} serve: the encoder launched {in_encoder}, "
                             f"expected {want_enc}")
    # each group's bytes at the published count of its stack
    published = get_config(arch).groups
    full = all_bytes[0] + sum(b * g.count / c.count - b
                              for b, g, c in zip(group_bytes, published, cfg.groups))
    B, P, N = B_SERVE, P_SERVE, N_SERVE
    say("serve", f"{cfg.name} bf16 B={B} prompt={P} new={N}, first full-width run of it in "
                 f"this process: prefill {B * P / t_pre:.1f} tok/s "
                 f"({t_pre * 1e3:.2f} ms), decode {B * N / t_dec:.2f} tok/s "
                 f"({t_dec / N * 1e3:.3f} ms/step; step 0 with the capture "
                 f"{t_first * 1e3:.2f} ms, the {N - 1} replays "
                 f"{(t_dec - t_first) / (N - 1) * 1e3:.3f} ms/step), "
                 f"parameters {all_bytes[0] / 1e9:.3f} GB ({cfg.n_layers} layers; "
                 f"{full / 1e9:.3f} GB at the published {get_config(arch).n_layers}), "
                 f"peak memory {peak / 2**30:.3f} GiB ({peak / 1e9:.3f} GB), "
                 f"launches {({n: c[0] for n, c in counts.items()})} (in the encoder "
                 f"{in_encoder}), plain calls on the card "
                 f"{({n: c[1] for n, c in counts.items()})} | {gpu}")
    return ({name: counts[name][0] for name, n in want.items() if n},
            {name: in_encoder[name] for name, n in want.items() if n})


def phase_ring(gpu: str) -> None:
    """recurrentgemma-9b at full width, one sequence whose prompt of 2560
    overruns the 2048 window: prefill and greedy decode through the entry
    points serve calls (``models.decode``), with the caches in hand.  The
    same launches as the serve run, finite logits, and after decode, which
    replays the captured step over the wrapped rings, every LOCAL layer's
    ring holds exactly the last 2048 positions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import use_kernels
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import init_params

    cfg = get_config(RING_ARCH)
    want = prefill_launches(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    prompts = np.random.default_rng(1).integers(2, cfg.vocab_size, size=(1, P_RING))
    tokens = torch.from_numpy(prompts).cuda()
    use_kernels(True)
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = dec.prefill(cfg, params, tokens, capacity=P_RING + N_RING)
        finite = bool(torch.isfinite(logits).all())
        t_pre = time.perf_counter() - t0
        counts = read_counts()
        t0 = time.perf_counter()
        steps = dec.DecodeGraph(cfg, params, caches, logits.argmax(-1)[:, None], P_RING, N_RING)
        step_finite = [torch.isfinite(steps.step()).all() for _ in range(N_RING)]
        finite = finite and bool(torch.stack(step_finite).all())
        t_dec = time.perf_counter() - t0
    finally:
        use_kernels(False)
    check_counts("ring run prefill", counts, want)
    if read_counts() != counts:
        raise AssertionError(f"ring run decode launched a kernel: {read_counts()}")
    if not finite:
        raise AssertionError("ring run: non-finite logits")
    if steps.graph is None:
        raise AssertionError("ring run: decode was not captured")
    last = list(range(P_RING + N_RING - cfg.window, P_RING + N_RING))
    n_local = 0
    for group, gc in zip(cfg.groups, caches):
        for kind, c in zip(group.pattern, gc):
            if kind != "local":
                continue
            for rep in range(group.count):
                n_local += 1
                if sorted(c["pos"][rep].tolist()) != last:
                    raise AssertionError(f"ring run: a LOCAL cache holds positions other than "
                                         f"{last[0]} .. {last[-1]}")
    if n_local != sum(g.pattern.count("local") * g.count for g in cfg.groups):
        raise AssertionError(f"ring run: {n_local} LOCAL caches checked")
    say("serve", f"{cfg.name} bf16 B=1 prompt={P_RING} new={N_RING} (window {cfg.window} "
                 f"binds): prefill {t_pre * 1e3:.2f} ms, decode {t_dec / N_RING * 1e3:.3f} "
                 f"ms/step (step 0 eager, then {N_RING - 1} replays), launches "
                 f"{({n: c[0] for n, c in counts.items()})}, plain calls on the card "
                 f"{({n: c[1] for n, c in counts.items()})}, logits finite, each of "
                 f"the {n_local} LOCAL rings holds positions {last[0]} .. {last[-1]} | {gpu}")


def _launch_call(name: str) -> str:
    """A host launch call's name without a versioned API suffix (``_v7000``)."""
    return re.sub(r"_v\d+$", "", name)


def phase_breakdown(gpu: str, arch: str) -> None:
    """Where serve's time goes.  Wall times come from a few runs without the
    profiler; device busy time (the sum of the device operations' times, one
    stream, so they do not overlap) from one run under torch.profiler, each
    operation assigned to the serve span (``prefill``, ``decode``) its start
    falls in.  Both spans end in a synchronise, so every operation of a
    phase starts inside its span.  The profile must show exactly the path's
    kernel launches.  torch.profiler has been seen to drop a session's last
    device events (a profile missing one flash launch of 16); such a session
    is run again, up to PROFILE_TRIES sessions in all.

    Decode's span holds step 0 (run eagerly as the capture's warm-up, then
    captured; the capture synchronises first, so step 0's operations all
    start inside its own ``decode.step`` span) and N - 1 replays, which are
    also read apart: the device operations that start after step 0's span,
    their wall from serve's metrics (decode less its first step), and the
    host's launch calls inside each later step's span, which must be one
    ``cudaGraphLaunch`` and nothing else.  Their device busy share is read
    in the profiled run alone: the replays' device operations over the
    window from the first one's start to the last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    N = N_SERVE
    want = {pname: n for name, n in prefill_launches(serve_config(arch)).items()
            for pname in PROFILER_NAME[name]}
    torch.cuda.empty_cache()  # the last arch's weights, freed, leave the card
    walls = [serve_once(arch, quiet=True)[1:] for _ in range(WARM_RUNS[arch])]
    for r, (t_pre, t_dec, t_first) in enumerate(walls, 1):
        say("breakdown", f"{arch} run {r}: prefill {t_pre * 1e3:.3f} ms, "
                         f"decode {t_dec / N * 1e3:.3f} ms/step (step 0 with the capture "
                         f"{t_first * 1e3:.3f} ms, replays "
                         f"{(t_dec - t_first) / (N - 1) * 1e3:.3f} ms/step)")
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve_once(arch, quiet=True)
        events = prof.events()
        spans = {e.name: e.time_range for e in events
                 if e.device_type == DeviceType.CPU and e.name in ("prefill", "decode")}
        steps = sorted((e.time_range for e in events
                        if e.device_type == DeviceType.CPU and e.name == "decode.step"),
                       key=lambda t: t.start)
        device_ops = [e for e in events if e.device_type == DeviceType.CUDA
                      and e.name not in ("prefill", "decode", "decode.step")]
        phases = {}
        for phase in ("prefill", "decode"):
            span = spans.get(phase)  # a span dropped too leaves no operations
            ops = [e for e in device_ops
                   if span and span.start <= e.time_range.start < span.end]
            phases[phase] = (ops, {kname: sum(kname in e.name for e in ops) for kname in want})
        bad = {phase: (len(ops), n_kernel) for phase, (ops, n_kernel) in phases.items()
               if not ops or n_kernel != (want if phase == "prefill" else dict.fromkeys(want, 0))}
        if len(steps) != N:
            bad["decode.step spans"] = len(steps)
        if not bad:
            break
        say("breakdown", f"{arch} profile session {attempt}: device operations and kernels "
                         f"recorded {bad}, expected kernels {want} in prefill")
    else:
        raise AssertionError(f"{arch} profile: {PROFILE_TRIES} sessions, the last recorded {bad}")
    replay_ops = [e for e in phases["decode"][0]
                  if steps[0].end <= e.time_range.start < spans["decode"].end]
    if not replay_ops:
        raise AssertionError(f"{arch}: the profile shows no device operation of the "
                             f"{N - 1} replayed decode steps")
    for i, (phase, per) in enumerate((("prefill", 1), ("decode", N))):
        span = spans[phase]
        ops, n_kernel = phases[phase]
        busy_us = sum(e.time_range.elapsed_us() for e in ops)
        wall_us = sorted(w[i] * 1e6 / per for w in walls)
        idle = [1 - busy_us / per / w for w in wall_us]
        unit = "step" if per > 1 else "call"
        say("breakdown", f"{arch} {phase} per {unit}: wall without profiler {wall_us[0]:.1f} .. "
                         f"{statistics.median(wall_us):.1f} .. {wall_us[-1]:.1f} us "
                         f"(min .. median .. max of {len(walls)}), under the profiler "
                         f"{span.elapsed_us() / per:.1f} us, device busy {busy_us / per:.1f} us, "
                         f"idle share {idle[0]:.3f} .. {idle[-1]:.3f}, "
                         f"{len(ops) / per:.0f} device operations, kernels {n_kernel}"
                         f" | {gpu}")
        label = phase
        if phase == "decode":  # the largest kernels of the replays
            ops, per, label = replay_ops, N - 1, "decode replay"
            busy_us = sum(e.time_range.elapsed_us() for e in ops)
        top_kernels(arch, label, ops, per, busy_us)
        for kname, n in n_kernel.items():  # the path's own kernels, in the top eight or not
            if n:
                t = sum(e.time_range.elapsed_us() for e in ops if kname in e.name)
                say("breakdown", f"  {arch} {phase}: {kname} {t / per:.1f} us "
                                 f"({100 * t / busy_us:.1f}%), {n} launches, "
                                 f"{t / n:.1f} us each")

    # the replayed steps
    calls = [e for e in events if e.device_type == DeviceType.CPU
             and _launch_call(e.name) in LAUNCH_CALLS]
    per_step = [collections.Counter(_launch_call(e.name) for e in calls
                                    if span.start <= e.time_range.start < span.end)
                for span in steps[1:]]
    if any(c != {"cudaGraphLaunch": 1} for c in per_step):
        raise AssertionError(f"{arch}: replayed decode steps made the launch calls {per_step}; "
                             "expected one cudaGraphLaunch a step")
    step0 = collections.Counter(_launch_call(e.name) for e in calls
                                if steps[0].start <= e.time_range.start < steps[0].end)
    wall_us = sorted((t_dec - t_first) * 1e6 / (N - 1) for _, t_dec, t_first in walls)
    busy_us = sum(e.time_range.elapsed_us() for e in replay_ops)
    window_us = (max(e.time_range.end for e in replay_ops)
                 - min(e.time_range.start for e in replay_ops))
    med = statistics.median(wall_us)
    say("breakdown", f"{arch} captured decode, per replayed step: wall without profiler "
                     f"{wall_us[0]:.1f} .. {med:.1f} .. {wall_us[-1]:.1f} us "
                     f"(min .. median .. max of {len(walls)}); under the profiler the replays' "
                     f"device window {window_us / (N - 1):.1f} us, device busy "
                     f"{busy_us / (N - 1):.1f} us, idle share {1 - busy_us / window_us:.4f}, "
                     f"{len(replay_ops) / (N - 1):.1f} device operations; host launch calls "
                     f"{dict(per_step[0])} in each of the {N - 1} replayed steps (step 0, eager "
                     f"and captured: {sum(step0.values())} launch calls) | {gpu}")


def top_kernels(arch: str, phase: str, ops: list, per: int, busy_us: float) -> None:
    """The eight device operations of ``ops`` that took the most time, per
    step (``per`` steps) and as a share of ``busy_us``."""
    by_name = {}
    for e in ops:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        say("breakdown", f"  {arch} {phase}: {t / per:9.1f} us {100 * t / busy_us:5.1f}% "
                         f"x{c / per:<6g} {name[:90]}")


def launches_of(launches: dict, name: str) -> int:
    """A kernel's launches over the serve runs of every path (arch -> row name
    -> launches), each read with the counts set to 0 just before it."""
    return sum(per_arch.get(name, 0) for per_arch in launches.values())


def softcap_library_call(q, k, v, softcap: float, want: torch.Tensor):
    """One PyTorch call for causal attention with a softcap, which SDPA lacks:
    ``flex_attention`` compiled to its fused kernel, with
    ``softcap * tanh(s / softcap)`` as its score_mod and a causal block mask.
    The mask is built and the call compiled here, outside any timing, and its
    output held against the plain version's ``want`` at phase 3's gate.  Used
    only as a yardstick: the port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def causal(b, h, q_idx, kv_idx):
        return kv_idx <= q_idx

    def cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(causal, None, None, q.shape[2], k.shape[2], device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)

    def call():
        return flex(q, k, v, score_mod=cap, block_mask=mask, enable_gqa=True)

    out = call()
    err = (out.float() - want.float()).abs().max().item()
    if not agrees(out, want, TOL[q.dtype]):
        raise AssertionError(f"flex_attention with softcap {softcap:g} disagrees with the "
                             f"plain version (max abs err {err:.3e}, gate {TOL[q.dtype]:g})")
    return call, err


def flash_timing(gpu: str, B, H, G, S, dh, dtype, window=0, softcap=0.0,
                 causal=True) -> dict:
    """The flash kernel, its plain version and one library call on one input
    in the model's layout, and the card's bound.  ``window`` must not bind
    at S: neither library call has it.  The library call is SDPA, or with a
    softcap, which SDPA has not, compiled ``flex_attention`` (causal only)."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = model_layout(np.random.default_rng(1), B, H, G, S, S, dh, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n_launch = kernel.launches
    ms = time_ms(lambda: kernel.flash_attention(qt, kt, vt, **kw))
    plain_ms = time_ms(lambda: attention_ref(qt, kt, vt, **kw))
    if softcap:
        t0 = time.perf_counter()
        lib_call, lib_err = softcap_library_call(qt, kt, vt, softcap,
                                                 attention_ref(qt, kt, vt, **kw))
        library, note = "flex_attention", (f" (compiled in {time.perf_counter() - t0:.1f} s, "
                                           f"{lib_err:.3e} from the plain version)")
    else:
        def lib_call():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        library, note = "scaled_dot_product_attention", ""
    lib_ms = time_ms(lib_call)
    kernel.launches = n_launch  # timing launches are not the main path's

    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * el  # q, o, k, v once each
    # QK^T and PV over the pairs attended: the causal ones, or all
    flops = 4 * dh * B * H * (S * (S + 1) // 2 if causal else S * S)
    bw, peak = next((p for n, p in PEAKS.items() if n in gpu), PEAKS["H100"])
    peak = peak if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
           "library": library}
    say("timing", f"flash_attention B={B} H={H} G={G} S={S} dh={dh} {str(dtype)[6:]} "
                  f"{'causal' if causal else 'non-causal'} "
                  f"window={window} softcap={softcap:g}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, {library}{note} {lib_ms:.4f} ms, bound "
                  f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {nbytes / 1e6:.2f} MB = "
                  f"{t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP = {t_ops:.4f} ms) | {gpu}")
    return out


def phase_timing(gpu: str, launches: dict, in_encoder: dict, errs: dict) -> dict:
    """The flash row at llama3.2-1b's prefill shape, with each path's own
    shape and launches under ``paths`` (whisper's encoder and decoder
    apart, each with the launches the serve run counted in it); a line
    besides for the f32 route."""
    paths = []
    for arch, label, part, H, G, S, dh, kw in FA_PATHS:
        archs = (arch,) if isinstance(arch, str) else arch
        t = flash_timing(gpu, FA_B, H, G, S, dh, torch.bfloat16, **kw)
        n = 0
        for a in archs:
            n_enc = in_encoder[a].get("flash_attention", 0)
            n += n_enc if part == "encoder" else launches[a]["flash_attention"] - n_enc
        mask = "causal" if kw.get("causal", True) else "non-causal"
        shape = (f"B={FA_B} H={H} G={G} S={S} dh={dh} bf16 {mask}"
                 f"{''.join(f' {k}={v:g}' for k, v in kw.items() if k != 'causal')}")
        paths.append(dict(arch=", ".join(archs), part=part, shape=shape, launches=n,
                          max_abs_err=errs[label], **t))
    # the f32 route (the CUDA-core kernel) at llama's shape, for its own record
    _, _, _, H, G, S, dh, _ = FA_PATHS[0]
    flash_timing(gpu, FA_B, H, G, S, dh, torch.float32)
    main = paths[0]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
        "launches": launches_of(launches, "flash_attention"),
        "max_abs_err": main["max_abs_err"],
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "library")},
        "paths": paths,
    }


def wkv6_work(B, S, H, K, chunk, el) -> tuple:
    """(bytes, f32 operations, exponentials) that WKV6 needs at this shape:
    r, k, v and y read or written once in ``el`` bytes each, log_w once in
    f32, the final state once in f32.  Operations per (b, h), per chunk of n
    tokens: the cumulative sum (n K adds); for each of the n(n-1)/2 pairs
    s < t and each k, the decay difference, two products and a sum (4);
    att @ v over the pairs (2 V each); the bonus term (3 K + 2 V per token);
    the decayed r and its product with the state (K + 2 K V per token); the
    decayed k and its outer products with v (K + 2 K V per token) and the
    state's own decay (K V per chunk).  Exponentials: one per pair and k,
    two per token and k, one per chunk and k."""
    V = K
    nbytes = (4 * el + 4) * B * S * H * K + 4 * B * H * K * V + 4 * H * K
    flops = exps = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        pairs = n * (n - 1) // 2
        flops += (n * K + pairs * (4 * K + 2 * V) + n * (3 * K + 2 * V)
                  + n * (2 * K + 4 * K * V) + K * V)
        exps += pairs * K + 2 * n * K + K
    return nbytes, flops * B * H, exps * B * H


def profiled_ms(fn, names, calls: int = 20, tries: int = PROFILE_TRIES) -> tuple:
    """Device ms per launch of each CUDA kernel whose name contains one of
    ``names``, from torch.profiler over ``calls`` calls after a warm-up,
    and how many launches of each the profiler recorded.  The profiler has
    been seen to drop some of a session's device events late in a process
    that ran large profiles before: the mean is over the launches recorded,
    and a session that recorded fewer than half of any kernel's is run again,
    up to ``tries`` sessions in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = {name: [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and name in e.name] for name in names}
        counts = {name: len(e) for name, e in evs.items()}
        if all(calls // 2 <= n <= calls for n in counts.values()):
            return ({name: sum(x.time_range.elapsed_us() for x in e) / len(e) / 1e3
                     for name, e in evs.items()}, counts)
    raise AssertionError(f"profile: launches {counts} in {calls} calls, {tries} sessions")


def phase_wkv_timing(gpu: str, launches: dict, main_err: float, parts: dict) -> dict:
    from repro_torch.kernels.rwkv6 import kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    s = WKV_SHAPE
    B, S, H, K, chunk, dtype = s["B"], s["S"], s["H"], s["K"], s["chunk"], s["dtype"]
    r, k, v, log_w, u = wkv_inputs(np.random.default_rng(1), B, S, H, K, dtype, "model_clipped")
    n_launch = kernel.launches
    ms = time_ms(lambda: kernel.wkv6(r, k, v, log_w, u, chunk=chunk))
    plain_ms = time_ms(lambda: wkv6_ref(r, k, v, log_w, u), reps=5, iters=2, warmup=1)
    kernel.launches = n_launch  # timing launches are not the main path's

    el = torch.tensor([], dtype=dtype).element_size()
    nbytes, flops, exps = wkv6_work(B, S, H, K, chunk, el)
    bw = next((p[0] for n, p in PEAKS.items() if n in gpu), PEAKS["H100"][0])
    t_bytes, t_ops = nbytes / bw * 1e3, flops / F32_FLOPS * 1e3
    row = {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:81",
        "launches": launches_of(launches, "wkv6"),
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "parts_ms": parts,
    }
    say("timing", f"wkv6 B={B} S={S} H={H} K={K} chunk={chunk} bf16 r/k/v, f32 log_w: "
                  f"kernel {ms:.4f} ms (under the profiler, phase 3: "
                  f"{', '.join(f'{n} {t:.4f} ms' for n, t in parts.items())}), "
                  f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}: {nbytes / 1e6:.2f} MB = {t_bytes:.4f} ms, "
                  f"{flops / 1e9:.3f} GFLOP f32 = {t_ops:.4f} ms; {exps / 1e6:.1f} M exponentials "
                  f"besides) | {gpu}")
    say("timing", "wkv6 library: none; no single PyTorch call computes WKV6 "
                  "(library_ms null)")
    return row


def lru_work(B, S, W, el) -> tuple:
    """(bytes, f32 operations) that the RG-LRU scan needs at this shape: a and
    b read once and y written once in ``el`` bytes each; one multiply and
    one add per element."""
    n = B * S * W
    return 3 * n * el, 2 * n


def phase_lru_timing(gpu: str, launches: dict, main_err: float) -> dict:
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_ref

    s = LRU_SHAPE
    B, S, W, dtype = s["B"], s["S"], s["W"], s["dtype"]
    a, b = lru_inputs(np.random.default_rng(1), B, S, W, dtype, "model")
    n_launch = kernel.launches
    ms = time_ms(lambda: kernel.rglru_scan(a, b))
    plain_ms = time_ms(lambda: rglru_ref(a, b), reps=5, iters=2, warmup=1)
    kernel.launches = n_launch  # timing launches are not the main path's

    el = torch.tensor([], dtype=dtype).element_size()
    nbytes, flops = lru_work(B, S, W, el)
    bw = next((p[0] for n, p in PEAKS.items() if n in gpu), PEAKS["H100"][0])
    t_bytes, t_ops = nbytes / bw * 1e3, flops / F32_FLOPS * 1e3
    L, C = kernel.chunking(S)
    row = {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:52",
        "launches": launches_of(launches, "rglru_scan"),
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    say("timing", f"rglru_scan B={B} S={S} W={W} {str(dtype)[6:]} (model draw, {C} chunks of "
                  f"{L}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB = "
                  f"{t_bytes:.4f} ms, {flops / 1e6:.1f} MFLOP f32 = {t_ops:.5f} ms), kernel at "
                  f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s of the bound's bytes | {gpu}")
    say("timing", "rglru_scan library: none; no single PyTorch call computes a first-order "
                  "linear recurrence (library_ms null)")
    return row


# -- phase 8: training ----------------------------------------------------------

def phase_train_refuses_grad() -> None:
    """Each kernel wrapper, given CUDA inputs that require grad with grad
    mode on, raises before launching: its output would carry no grad_fn."""
    rng = np.random.default_rng(0)
    inputs = {
        "flash_attention": [t.transpose(1, 2) for t in model_layout(
            rng, 1, 2, 2, 64, 64, 64, torch.float32)],
        "wkv6": list(wkv_inputs(rng, 1, 32, 2, 64, torch.float32, "exp_normal")),
        "rglru_scan": list(lru_inputs(rng, 1, 64, 32, torch.float32, "uniform")),
    }
    for name, (kern, _) in kernel_modules().items():
        args = [t.clone().requires_grad_() for t in inputs[name]]
        before = kern.launches
        try:
            getattr(kern, name)(*args)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            msg = str(e)
        else:
            raise AssertionError(f"{name}: inputs that require grad were not refused")
        if kern.launches != before:
            raise AssertionError(f"{name}: launched while refusing inputs that require grad")
        say("train", f"{name} refuses CUDA inputs that require grad: {msg[:100]}...")


def _train_data(cfg, B: int, S: int):
    from repro_torch.data import SyntheticLM

    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0,
                       frontend_tokens=cfg.frontend_tokens,
                       frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend_tokens
                       else 0)


def phase_train_parity(arch: str) -> None:
    """Smoke-width ``train_step`` in f32 with kernels off, as the reference
    trains: ``TRAIN_PARITY_STEPS`` steps from one set of weights on the CPU
    and on the card (``warmup_steps=1``, so all but the first move the
    weights), on the same ``SyntheticLM`` batches (whisper's and
    llama-vision's frontend in the model's f32, their XATTN gates drawn
    non-zero); loss, ce, aux, grad_norm and lr each step within 1e-4 of the
    CPU's, then every parameter and moment leaf within 1e-4 of the leaf's
    largest magnitude; no kernel launched, no plain version called."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import kernels_enabled
    from repro_torch.models.convert import draw_xattn_gates, tree_leaves, tree_map
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import init_state

    if kernels_enabled():
        raise AssertionError("kernels are on at the training phase; training runs them off")
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    B, S = 2, 32
    run = RunConfig(model=cfg, seq_len=S, global_batch=B, n_microbatches=1, warmup_steps=1,
                    total_steps=TRAIN_PARITY_STEPS + 1)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    draw_xattn_gates(params, np.random.default_rng(0), torch.from_numpy)
    gpu_params = tree_map(lambda t: t.to("cuda"), params)
    sides = {"cpu": (params, init_state(params)), "cuda": (gpu_params, init_state(gpu_params))}
    data = _train_data(cfg, B, S)
    zero_counts()
    worst_metric, lrs = 0.0, []
    for step in range(TRAIN_PARITY_STEPS):
        batch = data.batch(step)
        metrics = {}
        for dev, (p, o) in sides.items():
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            p, o, m = train_step(cfg, run, p, o, b)
            sides[dev] = (p, o)
            metrics[dev] = {k: float(v) for k, v in m.items()}
        for k, want in metrics["cpu"].items():
            got = metrics["cuda"][k]
            if not (abs(got - want) <= 1e-4 * max(abs(want), 1.0)):
                raise AssertionError(f"{cfg.name} train step {step}: {k} {got} on the card, "
                                     f"{want} on the CPU")
            worst_metric = max(worst_metric, abs(got - want) / max(abs(want), 1.0))
        lrs.append(metrics["cpu"]["lr"])
    counts = read_counts()
    if any(c != (0, 0) for c in counts.values()):
        raise AssertionError(f"{cfg.name} train steps launched kernels: {counts}")
    (cp, co), (gp, go) = sides["cpu"], sides["cuda"]
    worst_leaf = 0.0
    for want, got in zip(tree_leaves((cp, co.mu, co.nu)), tree_leaves((gp, go.mu, go.nu))):
        err = float((got.cpu().double() - want.double()).abs().max()
                    / want.double().abs().max().clamp_min(1e-30))
        if not err <= 1e-4:
            raise AssertionError(f"{cfg.name} train: a {tuple(want.shape)} leaf differs by "
                                 f"{err:.3e} of its largest magnitude")
        worst_leaf = max(worst_leaf, err)
    if int(go.step) != TRAIN_PARITY_STEPS or lrs[0] != 0.0 or not lrs[-1] > 0.0:
        raise AssertionError(f"{cfg.name} train: step {int(go.step)}, lr {lrs}")
    say("train", f"{cfg.name} f32 B={B} S={S}: {TRAIN_PARITY_STEPS} train steps (lr {lrs}), "
                 f"CUDA vs CPU metrics {worst_metric:.3e}, parameters and moments "
                 f"{worst_leaf:.3e} of each leaf's largest magnitude (tol 1e-4), final loss "
                 f"{metrics['cpu']['loss']:.6f} CPU / {metrics['cuda']['loss']:.6f} CUDA, "
                 f"launches {({n: c[0] for n, c in counts.items()})}")


def phase_train_full(gpu: str, label: str, B: int, S: int, n_micro: int, steps: int,
                     warmup: int) -> list:
    """llama3.2-1b at full width in bf16 through ``launch.train.run``: the
    loss finite and lower at the last step than at the first, every kernel
    launch count 0 (training runs the plain path).  The step walls are the
    ones ``run`` returns (what it hands its straggler monitor: batch to the
    card, ``train_step``, the loss read back); tokens/s and ``mfu``, the model
    FLOPs 6 N tokens (N the parameter count, the tied head once) over the
    wall and the card's 989 TFLOP/s, from the steps after the first; peak
    memory over the run.  Then one more step under torch.profiler on the
    run's weights and optimizer state (``run`` updates both in place, the
    step count too): device busy, idle share and the five largest device
    operations.  Returns the run's losses."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import train
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import init_state

    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(model=cfg, seq_len=S, global_batch=B, n_microbatches=n_micro,
                    warmup_steps=warmup, total_steps=steps)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = init_state(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = train.run(cfg, run, seed=0, steps=steps, device="cuda", params=params,
                              opt_state=opt)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    check_counts(f"{cfg.name} train", counts, dict.fromkeys(counts, 0))
    if len(losses) != steps or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} train ({label}): losses {losses}")
    if int(opt.step) != steps:
        raise AssertionError(f"{cfg.name} train ({label}): the optimizer's step count reads "
                             f"{int(opt.step)} after {steps} steps")
    tokens = B * S
    steady = walls[1:]
    med = statistics.median(steady)
    flops = 6 * n_params * tokens
    say("train", f"{cfg.name} bf16 ({label}) B={B} S={S} microbatches={n_micro} remat "
                 f"{run.remat_policy} warmup {warmup}, {steps} steps: losses "
                 f"{[round(x, 4) for x in losses]}; step 0 {walls[0] * 1e3:.2f} ms; steps "
                 f"1..{steps - 1} {min(steady) * 1e3:.2f} .. {med * 1e3:.2f} .. "
                 f"{max(steady) * 1e3:.2f} ms (min .. median .. max), {tokens / med:.0f} tok/s, "
                 f"mfu {flops / med / MFU_PEAK:.4f} (6 x {n_params / 1e9:.4f} G x {tokens} "
                 f"tokens = {flops / 1e12:.2f} TFLOP a step over {MFU_PEAK / 1e12:.0f} TFLOP/s), "
                 f"peak memory {peak / 2**30:.3f} GiB ({peak / 1e9:.3f} GB), launches "
                 f"{({n: c[0] for n, c in counts.items()})} | {gpu}")

    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in _train_data(cfg, B, S).batch(steps).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(cfg, run, params, opt, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.name not in TRAIN_SPANS]
    if not ops:
        raise AssertionError(f"{cfg.name} train: the profile shows no device operation")
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    window_us = max(e.time_range.end for e in ops) - min(e.time_range.start for e in ops)
    say("train", f"{cfg.name} ({label}) one step under torch.profiler: wall {wall_us:.1f} us, "
                 f"device window {window_us:.1f} us, device busy {busy_us:.1f} us, idle share "
                 f"{1 - busy_us / wall_us:.4f} of the profiled wall "
                 f"({1 - busy_us / (med * 1e6):.4f} of the median unprofiled step), "
                 f"{len(ops)} device operations | {gpu}")
    # train_step's two parts on the device.  The profiler places each span
    # over the device operations launched inside it on the calling thread;
    # backward runs on autograd's own thread, outside ``train.grads``, so the
    # parts are cut by time: forward and backward from the first device
    # operation of ``train.grads`` to the first of ``train.update``, the
    # update from there on (one stream: the update's kernels follow the
    # backward's).
    starts = {e.name: e.time_range.start for e in events if e.name in TRAIN_SPANS}
    if set(starts) == set(TRAIN_SPANS):
        update_start = starts["train.update"]
        for name, lo, hi in (("forward and backward", starts["train.grads"], update_start),
                             ("update", update_start, math.inf)):
            inside = [e for e in ops if lo <= e.time_range.start < hi]
            t = sum(e.time_range.elapsed_us() for e in inside)
            end = max(e.time_range.end for e in inside)
            say("train", f"  {cfg.name} ({label}) {name}: device window "
                         f"{end - lo:.1f} us, busy {t:.1f} us ({100 * t / busy_us:.1f}% of the "
                         f"step's), {len(inside)} device operations")
    else:
        say("train", f"  {cfg.name} ({label}) the split into forward and backward and update: "
                     f"not measured (the profile holds the device ranges {sorted(starts)})")
    by_name = {}
    for e in ops:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        name = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "", name)
        say("train", f"  {cfg.name} ({label}): {t:10.1f} us {100 * t / busy_us:5.1f}% "
                     f"x{c:<5d} {name[:160]}")
    del params, opt, batch
    torch.cuda.empty_cache()
    return losses


def phase_train(gpu: str) -> None:
    """Phase 8: the kernels refuse inputs that require grad; the ten archs'
    train steps, card against CPU; llama3.2-1b at full width."""
    phase_train_refuses_grad()
    for arch in ARCHS:
        phase_train_parity(arch)
    for setting in TRAIN_SETTINGS:
        phase_train_full(gpu, *setting)


def copy_tiers(dev: torch.device) -> dict:
    """The copy tiers one card has beside the pageable host -> device copy,
    as ``bench_transfer``'s (make_buffer, transfer) pairs with their sizes
    (None: ``bench_transfer``'s own): each buffer is a (source, destination)
    pair made once a size, each transfer one copy that ends when the card
    has finished it."""

    def tier(src_on, dst_on, pinned):
        def make(s: int):
            def buf(on):
                if on == "card":
                    return torch.zeros(s, dtype=torch.uint8, device=dev)
                return torch.zeros(s, dtype=torch.uint8, pin_memory=pinned)
            return buf(src_on), buf(dst_on)

        def transfer(pair):
            src, dst = pair
            dst.copy_(src, non_blocking=pinned)
            torch.cuda.synchronize(dev)

        return make, transfer

    return {"copy_h2d pinned": ("copy_h2d", tier("host", "card", True), None),
            "copy_d2h pinned": ("copy_d2h", tier("card", "host", True), None),
            "copy_d2h pageable": ("copy_d2h", tier("card", "host", False), None),
            "copy_d2d": (None, tier("card", "card", False), D2D_SIZES)}


def fit_line(label: str, res, gpu: str) -> str:
    """alpha, beta and 1/beta of one fitted tier, failing the run on a fit
    that is negative, zero in beta or not finite."""
    a, b = res.fitted.alpha, res.fitted.beta
    if not (math.isfinite(a) and math.isfinite(b) and a >= 0 and b > 0):
        raise AssertionError(f"{label}: fitted alpha={a!r} beta={b!r}")
    return (f"{label}: alpha={a:.4e} s beta={b:.4e} s/B 1/beta={1e-9 / b:.3f} GB/s "
            f"(sizes {res.sizes[0]}-{res.sizes[-1]} B) | {gpu}")


def phase_fit(gpu: str) -> None:
    """Phase 9: the paper's §VI loop on the card through the port's planner:
    measure the copy tiers, fit each, register the host -> device fit as a
    machine, plan on it, and print the fit's residuals and drift."""
    from repro_torch.analysis import check_fit_residuals
    from repro_torch.core import get_machine, plan_messages, registered_machines
    from repro_torch.core.benchmark import (bench_host_device_roundtrip, bench_transfer,
                                            spec_from_measurements)
    from repro_torch.obs import drift

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    drift.reset()
    h2d = bench_host_device_roundtrip()
    for row in h2d.csv_rows("h2d"):
        say("fit", f"{row} | {gpu}")
    fits = {"copy_h2d pageable (bench_host_device_roundtrip)": ("copy_h2d", h2d)}
    for label, (reg_tier, (make, transfer), sizes) in copy_tiers(dev).items():
        res = bench_transfer(make, transfer, sizes) if sizes else bench_transfer(make, transfer)
        fits[label] = (reg_tier, res)
        torch.cuda.empty_cache()
    specs = {name: get_machine(name) for name in FIT_COMPARE}
    for label, (reg_tier, res) in fits.items():
        say("fit", fit_line(label, res, gpu))
        for size, t in zip(res.sizes, res.times):
            beside = " ".join(
                f"{name} {reg_tier}:on-socket {float(spec.tiers[f'{reg_tier}:on-socket'].time(float(size))):.3e} s"
                for name, spec in specs.items()) if reg_tier else "no registry tier"
            say("fit", f"  {label} {size} B: card {t:.3e} s | {beside}")

    spec = spec_from_measurements(FIT_NAME, h2d, injectors_per_node=1)
    plan = plan_messages(spec, 65536.0, 4)
    say("fit", f"{FIT_NAME}: registered={FIT_NAME in registered_machines()} "
               f"plan(64 KiB x 4)={plan.strategy} t={plan.predicted_time:.4e} s "
               f"alternatives={list(plan.alternatives)} | {gpu}")
    if FIT_NAME not in registered_machines() or plan.strategy != "gpudirect" \
            or not plan.predicted_time > 0:
        raise AssertionError(f"{FIT_NAME} did not register and plan gpudirect "
                             f"with a positive time: {plan}")
    found = check_fit_residuals(spec, {"gpu_net": list(zip(h2d.sizes, h2d.times))})
    for f in found:
        say("fit", f"residual warning: {f.check} {f.detail}")
    say("fit", f"{len(found)} fit-residual warning(s) (printed, not gated)")
    summary = drift.summary()
    tiers = {k: v for k, v in summary["tiers"].items() if k.startswith(f"{FIT_NAME}/")}
    say("fit", f"drift {json.dumps(tiers, sort_keys=True)}")
    say("fit", f"ok in {time.perf_counter() - t0:.1f} s")


def fresh_planner() -> None:
    """The registry's built-in ``tpu_v5e`` (a drill re-registers it degraded
    or shrunk), empty plan and lowering caches, and cold observability
    (metrics off and empty, no tracer, no drift, a fresh link-health
    monitor)."""
    from repro_torch import obs
    from repro_torch.comms.autotune import clear_plan_cache
    from repro_torch.core.machine import register_machine, tpu_machine_spec
    from repro_torch.core.schedule import clear_schedule_cache

    register_machine("tpu_v5e", tpu_machine_spec)
    clear_plan_cache()
    clear_schedule_cache()
    obs.reset_all()


def drill_run(cfg, device: str, **kw) -> dict:
    """One ``serve.run`` of ``cfg`` from a fresh planner, seed 0: its
    generations, printed lines, drill lines, metrics, the values of
    ``SHARED_METRICS``, the launch counts and the health snapshot."""
    from repro_torch.launch import serve
    from repro_torch.obs import health, metrics

    fresh_planner()
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen = serve.run(cfg, seed=0, device=device, **kw)
    text = buf.getvalue()
    snap = metrics.to_json()
    shared = {k: v for kind in ("counters", "gauges") for k, v in snap[kind].items()
              if k.startswith(SHARED_METRICS)}
    return {"gen": gen, "text": text, "snap": snap, "shared": shared,
            "lines": [ln for ln in text.splitlines() if DRILL_LINE.match(ln)],
            "counts": read_counts(), "health": health.monitor().snapshot()}


def same_drill(what: str, card: dict, cpu: dict) -> None:
    """The card's run printed the CPU's drill lines and ended with its
    values of ``SHARED_METRICS``."""
    if card["lines"] != cpu["lines"]:
        raise AssertionError(f"{what}: drill lines differ, card {card['lines']} "
                             f"CPU {cpu['lines']}")
    if card["shared"] != cpu["shared"]:
        raise AssertionError(f"{what}: metrics differ, card {card['shared']} "
                             f"CPU {cpu['shared']}")


def check_shed(what: str, gen: np.ndarray, batch: int, fail_at: int) -> None:
    """The last row holds tokens up to the step it was shed at and -1 after
    it; no other entry is -1."""
    if not ((gen[batch - 1, fail_at + 1:] == -1).all() and (gen[batch - 1, :fail_at + 1] >= 0).all()
            and (gen[:batch - 1] >= 0).all()):
        raise AssertionError(f"{what}: the -1 layout is wrong: {gen.tolist()}")


def phase_drills(gpu: str) -> list:
    """Phase 10: serve's per-step consult and its drills on the card.
    Returns the full-width shed drill's lines."""
    from repro_torch.configs import smoke_config
    from repro_torch.runtime.scenarios import generate

    t0 = time.perf_counter()
    cfg = serve_config(DRILL_ARCH)
    B, P, N = B_SERVE, P_SERVE, N_SERVE
    full = dict(batch=B, prompt_len=P, new_tokens=N)
    want = prefill_launches(cfg)
    torch.cuda.empty_cache()

    # (a) the consult on the main path
    drill_run(cfg, "cuda", **full)  # warm
    replays, consult = [], []
    for r in range(1, DRILL_RUNS + 1):
        run = drill_run(cfg, "cuda", **full)
        check_counts(f"{DRILL_ARCH} serve with the consult", run["counts"], want)
        h = run["snap"]["histograms"]
        plan = h["plan.select_allreduce_strategy.seconds"]
        if plan["count"] != N or run["lines"] != ["[serve] per-step plan: flat"]:
            raise AssertionError(f"the consult ran {plan['count']} times, expected {N}; "
                                 f"lines {run['lines']}")
        replay = (h["serve.decode.seconds"]["sum"]
                  - h["serve.decode.first_step.seconds"]["sum"]) / (N - 1)
        replays.append(replay)
        consult.append(plan["mean"])
        say("drills", f"{cfg.name} bf16 B={B} prompt={P} new={N} run {r}: replayed step "
                      f"{replay * 1e3:.4f} ms, plan.select_allreduce_strategy "
                      f"{plan['count']} calls, mean {plan['mean'] * 1e6:.3f} us "
                      f"(min {plan['min'] * 1e6:.3f}, max {plan['max'] * 1e6:.3f}), "
                      f"launches {({n: c[0] for n, c in run['counts'].items()})} | {gpu}")
    lo, hi = min(replays) * 1e3, max(replays) * 1e3
    say("drills", f"replayed step with the consult {lo:.4f}-{hi:.4f} ms over {DRILL_RUNS} runs "
                  f"({lo / REPLAY_BEFORE_MS[0] - 1:+.2%} .. {hi / REPLAY_BEFORE_MS[1] - 1:+.2%} "
                  f"against {REPLAY_BEFORE_MS[0]}-{REPLAY_BEFORE_MS[1]} ms before it); consult "
                  f"mean {statistics.mean(consult) * 1e6:.3f} us a step | {gpu}")

    # (b) the drills at full width
    degrade = dict(degrade_at=DEGRADE_AT, fail_at=FAIL_AT)
    card_full = {}
    # shed twice, to read the second capture's time twice in one process
    for mode in ("shed", "shrink", "shed"):
        run = card_full[mode] = drill_run(cfg, "cuda", **full, **degrade, fail_mode=mode)
        check_counts(f"{DRILL_ARCH} {mode} drill", run["counts"], want)
        gauges, h = run["snap"]["gauges"], run["snap"]["histograms"]
        if not any(ln.startswith(f"[serve] link tpu_v5e/dcn degraded at decode step")
                   for ln in run["lines"]) or gauges.get("health.links.degraded") != 1:
            raise AssertionError(f"{mode} drill: the link did not degrade: {run['lines']}, "
                                 f"health.links.degraded={gauges.get('health.links.degraded')}")
        for ln in run["lines"]:
            say("drills", f"{mode}: {ln}")
        if mode == "shed":
            check_shed("full-width shed", run["gen"], B, FAIL_AT)
            recapture = h.get("serve.decode.recapture.seconds", {"count": 0})
            if gauges.get("serve.batch.live") != B - 1 or recapture["count"] != 1:
                raise AssertionError(f"shed: serve.batch.live={gauges.get('serve.batch.live')}, "
                                     f"{recapture['count']} second captures")
            say("drills", f"shed at step {FAIL_AT}: second capture at B={B - 1} "
                          f"{recapture['sum'] * 1e3:.3f} ms, first capture at B={B} "
                          f"{h['serve.decode.capture.seconds']['sum'] * 1e3:.3f} ms, step 0 "
                          f"with it {h['serve.decode.first_step.seconds']['sum'] * 1e3:.3f} ms; "
                          f"decode {h['serve.decode.seconds']['sum'] * 1e3:.3f} ms for {N} "
                          f"steps | {gpu}")
        say("drills", f"{mode}: health {json.dumps(run['health'], sort_keys=True)}")

    # (c) agreement at smoke width, f32: card against CPU in this process
    scfg = dataclasses.replace(smoke_config(DRILL_ARCH), dtype="float32")
    base = drill_run(scfg, "cuda", **DRILL_SMOKE)
    for mode in ("shed", "shrink"):
        card = drill_run(scfg, "cuda", **DRILL_SMOKE, **degrade, fail_mode=mode)
        cpu = drill_run(scfg, "cpu", **DRILL_SMOKE, **degrade, fail_mode=mode)
        same_drill(f"smoke {mode} drill", card, cpu)
        if card["health"]["links"] != cpu["health"]["links"]:
            raise AssertionError(f"smoke {mode} drill: health differs")
        if mode == "shed":
            b = DRILL_SMOKE["batch"]
            check_shed("smoke shed", card["gen"], b, FAIL_AT)
            if not np.array_equal(card["gen"][:b - 1], base["gen"][:b - 1]):
                raise AssertionError(f"smoke shed: rows 0..{b - 2} differ from the unshed run's")
        if card_full[mode]["lines"] != cpu["lines"]:
            raise AssertionError(f"{mode}: the full-width drill lines {card_full[mode]['lines']} "
                                 f"differ from the CPU's {cpu['lines']}")
        say("drills", f"smoke f32 {mode}: card and CPU print the same {len(cpu['lines'])} "
                      f"drill lines and end with the same {len(cpu['shared'])} planner, "
                      f"health and runtime metrics; the full-width lines equal them"
                      + (f"; rows 0..{DRILL_SMOKE['batch'] - 2} equal the unshed run's"
                         if mode == "shed" else ""))

    # (d) the seeded scenario
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scenario.json")
        generate(SCENARIO_ARGS["seed"], SCENARIO_ARGS["total_steps"],
                 hosts=SCENARIO_ARGS["hosts"], n_events=SCENARIO_ARGS["n_events"],
                 tiers=SCENARIO_ARGS["tiers"]).save(path)
        card_full_sc = drill_run(cfg, "cuda", **full, scenario=path)
        card = drill_run(scfg, "cuda", **DRILL_SMOKE, scenario=path)
        cpu = drill_run(scfg, "cpu", **DRILL_SMOKE, scenario=path)
    check_counts(f"{DRILL_ARCH} scenario", card_full_sc["counts"], want)
    same_drill("smoke scenario", card, cpu)
    if card_full_sc["lines"] != cpu["lines"]:
        raise AssertionError(f"scenario: full-width lines {card_full_sc['lines']} differ "
                             f"from the CPU's {cpu['lines']}")
    for ln in card_full_sc["lines"]:
        say("drills", f"scenario: {ln}")
    fresh_planner()
    say("drills", f"ok in {time.perf_counter() - t0:.1f} s")
    return card_full["shed"]["lines"]


def phase_collectives(gpu: str) -> None:
    """Phase 11: the collectives across ranks on the card (see the module
    docstring)."""
    from repro_torch.comms import checks, routes
    from repro_torch.comms.autotune import select_allreduce_strategy
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.transformer import init_params

    t0 = time.perf_counter()
    fresh_planner()
    # (a) the route table
    for (backend, dev, op), route in sorted(routes.ROUTES.items()):
        say("collectives", f"route backend={backend} device={dev} op={op}: {route}")
    # the gradient's size: the parameters of llama3.2-1b at depth COLL_LAYERS,
    # drawn on the card and freed
    gcfg = cut_depth(TRAIN_ARCH, COLL_LAYERS)
    params = init_params(gcfg, torch.Generator(device="cuda").manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say("collectives", f"{COLL_WORLD} gloo ranks on the card, CUDA tensors; {gcfg.name}'s "
                       f"gradient {n} f32 elements = {4 * n / 1e9:.3f} GB a rank; card memory "
                       f"held by this process {torch.cuda.memory_reserved() / 1e9:.2f} GB")
    card = run_world(checks.card_run, COLL_WORLD, COLL_WORLD, n, COLL_CHUNKS, COLL_FIT_SIZES,
                     COLL_AUTOTUNE_SIZES, device="cuda", timeout=COLL_TIMEOUT)
    cpu = run_world(checks.run_checks, COLL_WORLD, COLL_WORLD, device="cpu", timeout=300.0)

    # (b) every wrapper and *_inner, card world against host world
    kinds = checks.hold(COLL_WORLD)
    for name in sorted(kinds):
        why = [checks.disagreement(name, card[r]["checks"][name], cpu[r][name],
                                   COLL_WORLD) for r in range(COLL_WORLD)]
        if any(why):
            raise AssertionError(f"card against host: {[w for w in why if w]}")
    say("collectives", f"card world = host world on {len(kinds)} checks, meshes (2, 2) and "
                       f"(1, 4): {sum(k == 'equal' for k in kinds.values())} equal, "
                       f"{sum(k == '1e-5' for k in kinds.values())} at 1e-5, compression at "
                       f"the reference's bound and 1e-6")

    # (c) the full-width gradient, each strategy
    full = [c["full"] for c in card]
    for s in full[0]["walls"]:
        if not all(f["exact"][s] for f in full):
            raise AssertionError(f"full width {s}: a rank's sum is not 10 g")
        walls = [f["walls"][s] for f in full]
        say("collectives", f"full width {s}: exact on every rank; wall {max(walls):.3f} s "
                           f"(ranks {', '.join(f'{w:.3f}' for w in walls)}), "
                           f"{full[0]['bytes'] / max(walls) / 1e9:.4f} GB/s a rank, "
                           f"{COLL_CHUNKS} chunks of {full[0]['bytes'] / COLL_CHUNKS / 1e6:.2f} MB"
                           f" | {gpu}")
    say("collectives", f"full width auto picked {full[0]['auto']}; peak memory a rank "
                       f"{', '.join('%.3f' % (f['peak_bytes'] / 1e9) for f in full)} GB")

    # (d) the fits and the measured autotune
    fit = card[0]["fit"]
    for s in (*checks.STRATEGIES, "flat_host", "bench_allreduce"):
        f = fit[s]
        a, b = f["alpha"], f["beta"]
        if not (math.isfinite(a) and math.isfinite(b) and b > 0):
            raise AssertionError(f"{s}: fitted alpha={a!r} beta={b!r}")
        times = ", ".join(f"{sz}: {t * 1e6:.1f}" for sz, t in zip(f["sizes"], f["times"]))
        say("collectives", f"fit {s}: alpha={a * 1e6:.2f} us beta={b:.4e} s/B "
                           f"1/beta={1e-9 / b:.4f} GB/s a rank; times (B: us) {times} | {gpu}")
    for i, rec in enumerate(fit["autotune"]):
        want = select_allreduce_strategy({"pod": 2, "data": COLL_WORLD // 2},
                                         float(rec["nbytes"]))
        picks = [c["fit"]["autotune"][i]["pick"] for c in card]
        say("collectives", f"measured_autotune {rec['nbytes']} B a rank: measured "
                           f"{ {k: round(v * 1e6, 1) for k, v in rec['measured'].items()} } us, "
                           f"pick {rec['pick']} (ranks {picks}), model pick {rec['model_pick']} "
                           f"(here {want}), agreed {rec['agreed']}; reported, not registered "
                           f"| {gpu}")

    # (e) NCCL at world 1
    ident = run_world(checks.identity, 1, device="cuda", backend="nccl", timeout=300.0)[0]
    if not all(ident.values()):
        raise AssertionError(f"NCCL world of 1: not the input: {ident}")
    say("collectives", f"NCCL world of 1 on a (1, 1) mesh: {sorted(ident)} each return the "
                       f"input; more ranks need more cards")
    say("collectives", f"ok in {time.perf_counter() - t0:.1f} s")


def _per_rank(values, fmt: str = "{:.3f}") -> str:
    return ", ".join(fmt.format(v) for v in values)


def phase_ranks_serve(gpu: str) -> None:
    """12(a): mixtral at full width and serve depth over 8 expert ranks on
    the card (``serve.run`` with ``--mesh-shape 1,8``), held to the dense
    path's run of the same weights in this process."""
    from repro_torch.comms import routes as comm_routes
    from repro_torch.launch import serve

    from repro_torch.sharding import tp_adapt

    cfg = dataclasses.replace(serve_config(EP_ARCH), capacity_factor=EP_CF)
    L, B, P, N = cfg.n_layers, B_SERVE, P_SERVE, N_SERVE
    if tp_adapt(cfg, EP_RANKS) != (cfg, 1):  # else the world would draw other weights
        raise AssertionError(f"tp_adapt changes {cfg.name} at tp {EP_RANKS}")
    fresh_planner()
    gc.collect()
    torch.cuda.empty_cache()
    dense = []
    with contextlib.redirect_stdout(io.StringIO()):
        dense_gen = serve.run(cfg, batch=B, prompt_len=P, new_tokens=N, seed=0, device="cuda",
                              report=dense)
    gc.collect()
    torch.cuda.empty_cache()
    (dense,) = dense
    say("ranks", f"dense {cfg.name} (capacity factor {EP_CF}) served in this process as in "
                 f"phase 5, then freed: card memory this process holds "
                 f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved | {gpu}")
    for op in ("all_to_all", "all_gather", "all_reduce"):
        say("ranks", f"route gloo cuda {op}: {comm_routes.ROUTES[('gloo', 'cuda', op)]}")
    t0 = time.perf_counter()
    ranks = []
    ep_gen = serve.run(cfg, batch=B, prompt_len=P, new_tokens=N, seed=0, device="cuda",
                       mesh_shape=EP_MESH, report=ranks)
    wall = time.perf_counter() - t0
    if len(ranks) != EP_RANKS:
        raise AssertionError(f"{len(ranks)} rank reports, expected {EP_RANKS}")
    got, want = ranks[0]["logits"], dense["logits"]
    for r, rep in enumerate(ranks):
        if not np.array_equal(rep["logits"], got):
            raise AssertionError(f"rank {r}'s logits differ from rank 0's")
        if rep["launches"] != {"flash_attention": (L, 0), "wkv6": (0, 0), "rglru_scan": (0, 0)}:
            raise AssertionError(f"rank {r} launched {rep['launches']}, expected flash {L} "
                                 "times (each prefill layer) and no plain call")
    # the routes of prefill: the ranks' slices in rank order against the dense path's
    ep_routes = [np.concatenate([np.sort(rep["routes"][i], -1) for rep in ranks])
                 for i in range(L)]
    agree = [float(np.mean(np.sort(d, -1) == e)) for d, e in zip(dense["routes"], ep_routes)]
    # tokens and logits: a row's logits at step s are comparable while its fed
    # tokens agree; a token may differ only where the dense logits' top two
    # lie within two tolerances of each other (bf16 may round the tie apart)
    same = dense_gen == ep_gen
    dists, means, flips, last = [], [], [], []
    for b in range(B):
        for step in range(N + 1):
            if step and not same[b, :step].all():
                break
            d = np.abs(got[step, b] - want[step, b])
            dists.append(float(d.max()))
            means.append(float(d.mean()))
            if step in (0, N):
                last.append(f"row {b} step {step}: {d.max():.4f}")
            if step < N and not same[b, step]:
                top = np.sort(want[step, b])[-2:]
                flips.append((b, step, float(top[1] - top[0])))
    say("ranks", f"{cfg.name} B={B} prompt={P} new={N} bf16 over {EP_RANKS} gloo ranks (mesh "
                 f"{EP_MESH}), against the dense path: tokens agree {int(same.sum())}/{same.size}"
                 f" (rows diverging at (row, step, dense top-2 margin) {flips}); logits where "
                 f"the fed tokens agree ({len(dists)} (step, row)): largest distance a "
                 f"position median {statistics.median(dists):.4f} (tol {EP_TOL}), max "
                 f"{max(dists):.4f}, {sum(x > EP_TOL for x in dists)} above the tolerance; "
                 f"mean distance {statistics.mean(means):.5f}; prefill's and the last step's "
                 f"{'; '.join(last)}; prefill routes agreeing per layer "
                 f"{_per_rank(agree, '{:.4f}')}; every rank's logits equal rank 0's | {gpu}")
    median = statistics.median(dists)
    if not median <= EP_TOL or min(agree) < EP_ROUTES:
        raise AssertionError(f"expert-parallel logits: median distance {median:.4f} from the "
                             f"dense path's (tolerance {EP_TOL}), prefill routes agreeing "
                             f"{min(agree)} (at least {EP_ROUTES})")
    if any(margin >= 2 * EP_TOL for _, _, margin in flips):
        raise AssertionError(f"a token differs where the dense logits' top two lie "
                             f"{2 * EP_TOL} or more apart: {flips}")
    steps = ranks[0]["step_seconds"]
    say("ranks", f"{cfg.name} expert-parallel: prefill {ranks[0]['prefill_seconds'] * 1e3:.1f} "
                 f"ms (ranks {_per_rank([r['prefill_seconds'] * 1e3 for r in ranks], '{:.1f}')}), "
                 f"decode {ranks[0]['decode_seconds']:.3f} s, {N} eager steps "
                 f"{min(steps) * 1e3:.1f} .. {statistics.median(steps) * 1e3:.1f} .. "
                 f"{max(steps) * 1e3:.1f} ms (min .. median .. max); dense path prefill "
                 f"{dense['prefill_seconds'] * 1e3:.1f} ms, decode {dense['decode_seconds']:.3f} "
                 f"s; world wall {wall:.1f} s | {gpu}")
    moe = [(name, which, sec) for name, which, sec in ranks[0]["spans"]
           if name.startswith("moe.")]
    if len(moe) != 3 * L * (N + 1):
        raise AssertionError(f"{len(moe)} MoE collective spans, expected {3 * L * (N + 1)}")
    per = [moe[3 * i:3 * i + 3] for i in range(L * (N + 1))]
    a2a = [1e3 * (c[0][2] + c[1][2]) for c in per]
    gather = [1e3 * c[2][2] for c in per]
    say("ranks", f"rank 0's all-to-all spans (dispatch + combine, ms) in prefill per layer "
                 f"{_per_rank(a2a[:L], '{:.2f}')}, all-gather {_per_rank(gather[:L], '{:.2f}')};"
                 f" in decode per layer (mean of {N} steps) "
                 f"{_per_rank([statistics.mean(a2a[L + l::L]) for l in range(L)], '{:.2f}')}, "
                 f"all-gather "
                 f"{_per_rank([statistics.mean(gather[L + l::L]) for l in range(L)], '{:.2f}')}"
                 f"; {100 * sum(a2a[L:] + gather[L:]) / 1e3 / ranks[0]['decode_seconds']:.1f}% "
                 f"of rank 0's decode wall | {gpu}")
    say("ranks", f"flash launches a rank {[r['launches']['flash_attention'][0] for r in ranks]}"
                 f"; peak memory a rank (GB) {_per_rank([r['peak_bytes'] / 1e9 for r in ranks])}"
                 f" | {gpu}")


def griffin_train_config():
    """12(b)'s recurrentgemma-9b: full width, one group of each of its two
    patterns (5 layers)."""
    from repro_torch.configs import LayerGroup, get_config

    cfg = get_config(GRIFFIN_TRAIN_ARCH)
    groups = tuple(LayerGroup(g.pattern, 1) for g in cfg.groups)
    depth = sum(len(g.pattern) for g in groups)
    return dataclasses.replace(cfg, name=f"{GRIFFIN_TRAIN_ARCH}-depth{depth}", groups=groups)


def _train_leg(cfg, B: int, S: int, steps: int) -> tuple:
    """(config, run config, world_run's kw) of a 12(b) leg: ``cfg`` (a full
    width config), bf16, trained ``steps`` steps from seed 0."""
    from repro_torch.configs.base import RunConfig

    run_cfg = RunConfig(model=cfg, seq_len=S, global_batch=B, n_microbatches=1,
                        warmup_steps=SHARD_WARMUP, total_steps=steps)
    return cfg, run_cfg, dict(seed=0, steps=steps, checkpoint_dir="", checkpoint_every=50,
                              log_every=1)


def cut_depth(arch: str, count: int):
    """``arch`` at full width with ``count`` repeats of its one group's
    pattern, named by its depth."""
    from repro_torch.configs import LayerGroup, get_config

    cfg = get_config(arch)
    (group,) = cfg.groups
    depth = len(group.pattern) * count
    return dataclasses.replace(cfg, name=f"{arch}-depth{depth}",
                               groups=(LayerGroup(group.pattern, count),))


def decode_config():
    """12(d)'s gemma2-9b: full width, f32, ``DECODE_GROUPS`` of its (LOCAL,
    ATTN) groups."""
    return dataclasses.replace(cut_depth(DECODE_ARCH, DECODE_GROUPS), dtype="float32")


def phase_ranks_train(gpu: str) -> None:
    """12(b): llama3.2-1b and rwkv6-1.6b (depth ``LEG_LAYERS``) and
    recurrentgemma-9b (depth 5) at full width trained over a (2, 2) world on
    the card (one world, in turn), each first loss held to the single-device
    step's on the same weights and batch (``launch.train.run``'s, taken here
    first); then, in the same world, 12(d): the dry-run's serving decode at
    batch 1 on the FSDP blocks and the caches' sequence chunks, held to one
    device's decode, taken here first."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_entry_world
    from repro_torch.sharding import checks as shard_checks
    from repro_torch.sharding import tp_adapt

    legs = [_train_leg(cut_depth(TRAIN_ARCH, LEG_LAYERS), *TRAIN_SETTINGS[0][1:3], SHARD_STEPS),
            _train_leg(cut_depth(RWKV_TRAIN_ARCH, LEG_LAYERS), LEG_B, LEG_S, LEG_STEPS),
            _train_leg(griffin_train_config(), LEG_B, LEG_S, LEG_STEPS)]
    dcfg = decode_config()
    if tp_adapt(dcfg, 2) != (dcfg, 1):  # else the world would draw other weights
        raise AssertionError(f"tp_adapt changes {dcfg.name} at tp 2")
    decode = (dcfg, SHARD_MESH, DECODE_CAP, DECODE_WRITTEN, DECODE_STEPS, 0)
    singles = []
    for cfg, run_cfg, _ in legs:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        losses, _ = train.run(cfg, run_cfg, seed=0, steps=1, device="cuda", log_every=1)
        singles.append((losses[0], "launch.train.run"))
        say("ranks", f"{cfg.name} one device's first loss {losses[0]:.6f} in "
                     f"{time.perf_counter() - t0:.1f} s | {gpu}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = shard_checks.long_decode_single(*decode[:1], *decode[2:], device="cuda")
    one["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    outs = run_entry_world(shard_checks.ranks_world_reports, SHARD_RANKS,
                           [(cfg, run_cfg, SHARD_MESH, 1, kw) for cfg, run_cfg, kw in legs],
                           decode, device="cuda")
    wall = time.perf_counter() - t0
    for i, ((cfg, run_cfg, kw), (loss0, single)) in enumerate(zip(legs, singles)):
        _say_train_leg(gpu, cfg.name, run_cfg.global_batch, run_cfg.seq_len, kw["steps"],
                       loss0, single, [o["train"][i] for o in outs])
    _say_decode_leg(gpu, dcfg, one, [o["decode"] for o in outs])
    say("ranks", f"12(b) and 12(d) world wall {wall:.1f} s for {len(legs)} train legs and "
                 f"the decode leg | {gpu}")


def _say_decode_leg(gpu: str, cfg, one: dict, out: list) -> None:
    """Hold 12(d)'s ranks (``out``: every rank's ``long_decode_report``) to
    one device's decode ``one`` and print their walls, collectives, cache
    bytes and peak memory."""
    from repro_torch.models import decode as dec

    data, model = (int(x) for x in SHARD_MESH.split(","))
    for o in out:
        if o["tokens"] != one["tokens"]:
            raise AssertionError(f"12(d) rank {o['coord']} tokens {o['tokens']} against one "
                                 f"device's {one['tokens']}")
    want = one["logits"]
    scale = float(np.abs(want).max())
    gaps = []
    for d in range(data):
        blocks = sorted((o["coord"][1], o["logits"]) for o in out if o["coord"][0] == d)
        got = np.concatenate([b for _, b in blocks], -1)
        gaps.append(float(np.abs(got - want).max()) / scale)
    if not max(gaps) <= DECODE_TOL:
        raise AssertionError(f"12(d) logits {gaps} of their largest magnitude {scale} from one "
                             f"device's (tol {DECODE_TOL})")
    whole = sum(t.numel() * t.element_size() for t in _leaves(
        dec.init_caches(cfg, 1, DECODE_CAP, device="meta")))
    calls, nbytes = out[0]["collective_calls"], out[0]["collective_bytes"]
    kinds = sorted(calls)
    per_step = ", ".join(f"{k} {calls[k] / DECODE_STEPS:g} calls "
                         f"{nbytes.get(k, 0) / DECODE_STEPS / 1e9:.6f} GB" for k in kinds)
    say("ranks", f"12(d) {cfg.name} f32 B=1 decode over {SHARD_RANKS} gloo ranks (mesh "
                 f"{SHARD_MESH}), the dry-run's serving steps on the weights' FSDP blocks and "
                 f"the caches' sequence chunks over 'data' (capacity {DECODE_CAP}, positions "
                 f"{DECODE_WRITTEN} .. {DECODE_WRITTEN + DECODE_STEPS - 1}): tokens "
                 f"{out[0]['tokens']} equal one device's on every rank; logits' largest distance "
                 f"{_per_rank(gaps, '{:.3e}')} of their largest magnitude {scale:.4f} (tol "
                 f"{DECODE_TOL}) | {gpu}")
    say("ranks", f"12(d) step walls a rank (s) "
                 f"{'; '.join(_per_rank(o['walls'], '{:.4f}') for o in out)}; one device's "
                 f"steps (s) {_per_rank(one['walls'], '{:.4f}')} ({one['seconds']:.1f} s with "
                 f"its draw); rank 0's collectives a step: {per_step}; cache bytes a rank (GB) "
                 f"{_per_rank([o['cache_bytes'] / 1e9 for o in out], '{:.4f}')} of "
                 f"{whole / 1e9:.4f} whole; peak memory a rank over the steps (GB) "
                 f"{_per_rank([o['peak_bytes'] / 1e9 for o in out])} | {gpu}")


def _say_train_leg(gpu: str, name: str, B: int, S: int, steps: int, single_loss0: float,
                   single: str, out: list) -> None:
    """Hold one 12(b) leg's first loss to ``single_loss0`` and print its
    spans and collectives (``out``: every rank's ``train_world_report``)."""
    losses = out[0]["losses"]
    if any(o["losses"] != losses for o in out) or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} sharded train losses {[o['losses'] for o in out]}")
    dist0 = abs(losses[0] - single_loss0)
    if not dist0 < SHARD_LOSS_TOL:
        raise AssertionError(f"{name} sharded first loss {losses[0]} against {single}'s "
                             f"{single_loss0}: {dist0} (tol {SHARD_LOSS_TOL})")
    spans = collections.defaultdict(list)
    model_ms = 0.0  # a step's model collectives: their spans close inside its train.grads
    for span, sec in out[0]["spans"]:
        if span.startswith("tp."):
            model_ms += sec * 1e3
            continue
        spans[span].append(sec * 1e3)
        if span == "train.grads":
            spans["tp"].append(model_ms)
            model_ms = 0.0
    calls, nbytes = out[0]["collective_calls"], out[0]["collective_bytes"]

    def per_step(kind: str) -> str:
        return (f"{calls.get(kind, 0) / steps:g} calls "
                f"{nbytes.get(kind, 0) / steps / 1e9:.4f} GB")

    say("ranks", f"{name} bf16 B={B} S={S} over {SHARD_RANKS} gloo ranks (mesh "
                 f"{SHARD_MESH}), {steps} steps warmup {SHARD_WARMUP}: losses "
                 f"{[round(x, 4) for x in losses]}; first loss {losses[0]:.6f} against {single}'s "
                 f"single-device {single_loss0:.6f}: {dist0:.2e} (tol {SHARD_LOSS_TOL}) | {gpu}")
    say("ranks", f"{name} sharded step, compute split over 'model', walls (s) "
                 f"{_per_rank(out[0]['walls'])}; per step (ms) gather "
                 f"{_per_rank(spans['train.gather'], '{:.1f}')}, forward and backward "
                 f"{_per_rank(spans['train.grads'], '{:.1f}')} (of it model collectives "
                 f"{_per_rank(spans['tp'], '{:.1f}')}), gradient reduce "
                 f"{_per_rank(spans['train.reduce'], '{:.1f}')}, update "
                 f"{_per_rank(spans['train.update'], '{:.1f}')}; rank 0's collectives a step: "
                 f"all-gathers {per_step('all_gather')}, w_in exchanges "
                 f"{per_step('send_recv')}, model all-reduces {per_step('model_all_reduce')}, "
                 f"model reduce-scatters {per_step('model_reduce_scatter')}, model all-gathers "
                 f"{per_step('model_all_gather')}, other all-reduces {per_step('all_reduce')}; "
                 f"peak memory a rank (GB) {_per_rank([o['peak_bytes'] / 1e9 for o in out])}"
                 f" | {gpu}")


def phase_ranks_checks(gpu: str) -> None:
    """12(c): the CPU tests' world programs at smoke width, a world on CUDA
    tensors against a world on the host, the two at once
    (``sharding.checks.compare_moe`` and ``compare_train``): the
    expert-parallel cases rank by rank and two sharded steps through the
    expert layer, the sharded train step's blocks and metrics."""
    from repro_torch.launch.mesh import run_world
    from repro_torch.sharding import checks as shard_checks

    W = shard_checks.WORLD
    args = (shard_checks.moe_inputs(), shard_checks.train_inputs(), CARD_TRAIN_CASES)
    # the host world runs beside the card world: both are checks, neither is timed
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(run_world, shard_checks.ranks_program, W, *args, device="cpu",
                           timeout=RANKS_TIMEOUT)
        card = run_world(shard_checks.ranks_program, W, *args, device="cuda",
                         timeout=RANKS_TIMEOUT)
        host = host.result()
    for name, key, compare, bounds in (
            ("expert-parallel", "moe", shard_checks.compare_moe,
             f"logits and aux f32 {shard_checks.CARD_TOL['float32']}, bf16 "
             f"{shard_checks.CARD_TOL['bfloat16']}; the train steps' blocks "
             f"{shard_checks.EP_TRAIN_TOL} of a leaf's largest magnitude; refused layouts "
             "raise the same ValueError on both"),
            ("sharded train", "train", shard_checks.compare_train,
             f"f32 blocks {shard_checks.F32_TOL} of a leaf's largest magnitude, RWKV's "
             f"{shard_checks.RWKV_F32_TOL}; bf16 parameters and loss "
             f"{shard_checks.TRAIN_BF16}")):
        worst, bad = compare([r[key] for r in card], [r[key] for r in host])
        if bad:
            raise AssertionError(f"{name} checks, card against host: {bad}")
        say("ranks", f"{name} checks, {W} ranks on the card against {W} on the host: "
                     f"largest gap of each case "
                     f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } ({bounds}) | {gpu}")
    from repro_torch.models.convert import tree_leaves

    def nbytes(out: dict, keys) -> int:
        return sum(t.size * 4 for k in keys for t in tree_leaves(out[k]))

    say("ranks", "sharded train, rank 0's bytes on the card (f32): " + "; ".join(
        f"{case} moments {nbytes(card[0]['train'][case], ('mu', 'nu'))}, parameters "
        f"{nbytes(card[0]['train'][case], ('params',))}" for case in MOMENT_CASES)
        + f" | {gpu}")


def phase_ranks(gpu: str) -> None:
    """Phase 12: the model across ranks on the card (see the module
    docstring)."""
    t0 = time.perf_counter()
    walls = []
    for part in (phase_ranks_serve, phase_ranks_train, phase_ranks_checks):
        t1 = time.perf_counter()
        part(gpu)
        walls.append(time.perf_counter() - t1)
    say("ranks", f"ok in {time.perf_counter() - t0:.1f} s (a {walls[0]:.1f}, b "
                 f"{walls[1]:.1f}, c {walls[2]:.1f})")


# -- phase 13: recovery and elastic re-scale -----------------------------------

def _scratch(need_gb: float) -> str:
    """A new temporary directory for checkpoints, where ``need_gb`` GB are
    free: the temporary directory's file system, else the checkout's
    ignored ``_checkpoints``; raises with both file systems' free space."""
    import shutil
    import tempfile

    tried = []
    for base in (tempfile.gettempdir(), str(ROOT / "_checkpoints")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free / 1e9
        tried.append(f"{base}: {free:.1f} GB free")
        if free >= need_gb:
            return tempfile.mkdtemp(prefix="recovery_", dir=base)
    raise RuntimeError(f"checkpoints need {need_gb} GB of disk, found {'; '.join(tried)}")


def _timed_checkpointer(directory: str, keep: int, device: str):
    """A ``Checkpointer`` that records each ``save`` call's seconds (the
    device -> host snapshot; the file is written on its thread), each
    ``np.savez``'s seconds (the write) and each ``restore``'s seconds."""
    from repro_torch.checkpoint import Checkpointer, checkpointer as ck_module

    class Timed(Checkpointer):
        snapshots, writes, restores = [], [], []

        def save(self, step, tree, block=True):
            t0 = time.perf_counter()
            super().save(step, tree, block=block)
            self.snapshots.append(time.perf_counter() - t0)

        def restore(self, *a, **k):
            sync()
            t0 = time.perf_counter()
            out = super().restore(*a, **k)
            sync()
            self.restores.append(time.perf_counter() - t0)
            return out

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    savez = ck_module.np.savez

    def timed_savez(*a, **k):
        t0 = time.perf_counter()
        savez(*a, **k)
        Timed.writes.append(time.perf_counter() - t0)

    ck_module.np.savez = timed_savez  # restored by the caller: see recovery_case
    return Timed(directory, keep=keep), (ck_module.np, savez)


def _diff_leaves(got, want) -> list:
    """(name, largest |difference|) of each leaf of two trees that differs."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names

    out = []
    for (name, a), (_, b) in zip(_flatten_with_names(got), _flatten_with_names(want)):
        if not torch.equal(a, b):
            out.append((name, float((a.float() - b.float()).abs().max())))
    return out


def recovery_config():
    """Phase 13's llama3.2-1b: full width, ``REC_LAYERS`` layers."""
    return cut_depth(TRAIN_ARCH, REC_LAYERS)


def recovery_case(workdir: str, device: str = "cuda") -> dict:
    """13(a) in this process: llama3.2-1b at full width and depth
    ``REC_LAYERS`` trained ``REC_STEPS``
    steps straight through, then again under ``run_with_recovery`` with
    the faults of ``REC_FAULTS``; the leaves that differ between the two
    final states, and the run's numbers."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.machine import get_machine, register_machine
    from repro_torch.data import SyntheticLM
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import init_state
    from repro_torch.runtime import (BackoffPolicy, HostLost, InjectedFault, run_with_recovery,
                                     shrink_and_replan)

    cfg = recovery_config()
    run = RunConfig(model=cfg, seq_len=REC_S, global_batch=REC_B, n_microbatches=1,
                    warmup_steps=REC_WARMUP, total_steps=REC_STEPS)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=REC_S, global_batch=REC_B, seed=0)

    def batch_fn(step):
        return {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to(device)}

    walls = []

    def step_fn(p, o, b):
        t0 = time.perf_counter()
        p, o, m = train_step(cfg, run, p, o, b)
        float(m["loss"])  # waits for the card
        walls.append(time.perf_counter() - t0)
        return p, o, m

    def fresh():
        p = init_params(cfg, torch.Generator(device=device).manual_seed(0))
        return p, init_state(p)

    cuda = device == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    clean_p, clean_o = fresh()
    for step in range(REC_STEPS):
        clean_p, clean_o, _ = step_fn(clean_p, clean_o, batch_fn(step))
    clean_walls = walls[:]
    walls.clear()
    base = get_machine("summit")
    register_machine(REC_MACHINE, dataclasses.replace(
        base, name=REC_MACHINE, facts={**base.facts, "n_gpus": 12, "ppn": 6},
        derived_from="summit"))
    pending = {s: (InjectedFault(f"injected at step {s}") if kind == "InjectedFault"
                   else HostLost(REC_LOST_HOST)) for s, kind in REC_FAULTS.items()}

    def hook(step):
        if step in pending:
            raise pending.pop(step)

    drops, delays, logs = [], [], []

    def on_drop(e, step):
        shrunk = shrink_and_replan(REC_MACHINE, [e.host])
        drops.append((step, e.host, int(shrunk.facts["n_gpus"]), shrunk.fingerprint))

    ckpt, (np_module, savez) = _timed_checkpointer(workdir, keep=2, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    p0, o0 = fresh()
    try:
        state = run_with_recovery(
            step_fn=step_fn, batch_fn=batch_fn, init_params=p0, init_opt=o0,
            checkpointer=ckpt, total_steps=REC_STEPS, checkpoint_every=REC_EVERY,
            fault_hook=hook, backoff=BackoffPolicy(base=0.01, max_delay=0.05, seed=0),
            sleep_fn=delays.append, on_host_drop=on_drop, log=logs.append)
    finally:
        np_module.savez = savez
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del p0, o0
    differ = _diff_leaves({"params": state.params, "opt": state.opt_state},
                          {"params": clean_p, "opt": clean_o})
    with open(os.path.join(workdir, f"step_{REC_STEPS:08d}", "meta.json")) as f:
        meta = json.load(f)
    npz = os.path.getsize(os.path.join(workdir, f"step_{REC_STEPS:08d}", "arrays.npz"))
    n_leaves = len(tree_leaves(state.params)) + len(tree_leaves(state.opt_state))
    out = {"step": state.step, "differ": differ, "n_leaves": n_leaves, "logs": logs,
           "drops": drops, "delays": delays, "snapshots": list(ckpt.snapshots),
           "writes": list(ckpt.writes), "restores": list(ckpt.restores),
           "ckpt_gb": npz / 1e9, "ckpt_leaves": len(meta["names"]), "peak_bytes": peak,
           "clean_walls": clean_walls, "walls": walls, "pending": sorted(pending)}
    del state, clean_p, clean_o
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def recovery_subprocess(workdir: str) -> dict:
    """13(a) again in a new process with cuBLAS's fixed workspace and
    ``torch.use_deterministic_algorithms(True)``, both set before its CUDA
    context: the results as JSON on its last line."""
    code = ("import json, os, sys, torch; torch.use_deterministic_algorithms(True); "
            "import chip_smoke as c; torch.backends.cuda.matmul.allow_tf32 = False; "
            f"print(json.dumps(c.recovery_case({workdir!r})))")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"deterministic recovery run failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_recovery_full(gpu: str) -> None:
    """13(a): recovery through a fault and a host loss at full width,
    bitwise against the uninterrupted run."""
    import shutil

    workdir = _scratch(CKPT_GB)
    try:
        res = recovery_case(workdir)
        mode = "default algorithms"
        if res["differ"]:
            say("recovery", f"not bitwise with {mode}: {len(res['differ'])} of "
                            f"{res['n_leaves']} leaves differ, the largest gaps "
                            f"{sorted(res['differ'], key=lambda x: -x[1])[:6]} | {gpu}")
            shutil.rmtree(workdir, ignore_errors=True)
            os.makedirs(workdir)
            res = recovery_subprocess(workdir)
            mode = "CUBLAS_WORKSPACE_CONFIG=:4096:8 and deterministic algorithms"
        if res["differ"] or res["step"] != REC_STEPS or res["pending"]:
            raise AssertionError(f"recovery ({mode}): step {res['step']}, faults not raised "
                                 f"{res['pending']}, leaves that differ {res['differ']}")
        drops, delays = res["drops"], res["delays"]
        if len(delays) != len(REC_FAULTS) or [tuple(d[:3]) for d in drops] != [
                (7, REC_LOST_HOST, 11)]:
            raise AssertionError(f"recovery: delays {delays}, host drops {drops}")
        say("recovery", f"{recovery_config().name} bf16 B={REC_B} S={REC_S} {REC_STEPS} steps, a checkpoint "
                        f"every {REC_EVERY}, faults {REC_FAULTS}: final parameters and moments "
                        f"bitwise the uninterrupted run's ({res['n_leaves']} leaves, {mode}); "
                        f"log {res['logs']} | {gpu}")
        say("recovery", f"checkpoint {res['ckpt_gb']:.3f} GB ({res['ckpt_leaves']} leaves); "
                        f"saves (device -> host snapshot) {_per_rank(res['snapshots'])} s, "
                        f"writes (np.savez) {_per_rank(res['writes'])} s, restores "
                        f"{_per_rank(res['restores'])} s; restarts {len(delays)}, backoff delays "
                        f"{_per_rank(delays, '{:.6f}')} s (slept through sleep_fn, not "
                        f"waited); host {drops[0][1]} lost at step {drops[0][0]}: "
                        f"{REC_MACHINE} shrunk to {drops[0][2]} ranks, fingerprint "
                        f"{drops[0][3][:12]}; peak memory {res['peak_bytes'] / 1e9:.3f} GB | {gpu}")
        say("recovery", f"step walls (s) uninterrupted {_per_rank(res['clean_walls'])}; under "
                        f"recovery ({len(res['walls'])} steps run, replays included) "
                        f"{_per_rank(res['walls'])} | {gpu}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_rescale(gpu: str) -> None:
    """13(b): llama3.2-1b at full width and depth ``REC_LAYERS`` over (2, 2),
    then (2, 1), then (2, 2) again, gloo worlds on the card with a
    checkpoint as the hand-off (``runtime.checks.leg_program``)."""
    import shutil

    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import run_world
    from repro_torch.runtime import checks as rt_checks

    cfg = recovery_config()
    run = RunConfig(model=cfg, seq_len=REC_S, global_batch=REC_B, n_microbatches=1,
                    warmup_steps=REC_WARMUP, total_steps=REC_STEPS)
    workdir = _scratch(CKPT_GB)
    blob, ref = os.path.join(workdir, "blob"), os.path.join(workdir, "uninterrupted")
    leg = dict(cfg=cfg, run=run, keep=2)
    big, small, back = RESCALE_MESHES
    worlds = [
        (big, [dict(leg, mesh=big, seed=0, synthetic=(0, 0, 2), save=(blob, 2)),
               dict(leg, mesh=big, synthetic=(0, 2, 4), save_params=(ref, 4))]),
        (small, [dict(leg, mesh=small, restore=(blob, 2), check=True, synthetic=(0, 2, 3),
                      save=(blob, 3))]),
        (back, [dict(leg, mesh=back, restore=(blob, 3), synthetic=(0, 3, 4),
                     compare=(ref, 4))]),
    ]
    out = []
    try:
        gc.collect()
        torch.cuda.empty_cache()
        for dims, legs in worlds:
            t0 = time.perf_counter()
            res = run_world(rt_checks.leg_program, math.prod(dims), legs, device="cuda",
                            timeout=RESCALE_TIMEOUT)
            out.append((dims, res, time.perf_counter() - t0))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    (_, first, _), (_, shrunk, _), (_, grown, _) = out
    loss = lambda ranks, leg_i, step: ranks[0][leg_i]["metrics"][step]["loss"]  # noqa: E731
    for dims, ranks, _ in out:
        for i in range(len(ranks[0])):
            per = {tuple(m["loss"] for m in r[i]["metrics"]) for r in ranks}
            if len(per) != 1:
                raise AssertionError(f"world {dims}: the ranks' losses differ {per}")
    straight = [loss(first, 0, 0), loss(first, 0, 1), loss(first, 1, 0), loss(first, 1, 1)]
    resc = [loss(shrunk, 0, 0), loss(grown, 0, 0)]
    gaps = [abs(resc[0] - straight[2]), abs(resc[1] - straight[3])]
    dist = max(r[0]["max_param_distance"] for r in grown)
    checked = [r[0]["leaves_checked"] for r in shrunk]
    if not (all(np.isfinite(straight + resc)) and max(gaps) < RESCALE_LOSS
            and dist < RESCALE_PARAMS):
        raise AssertionError(f"re-scale: uninterrupted losses {straight}, re-scaled {resc} "
                             f"(gaps {gaps}, tol {RESCALE_LOSS}), final parameters "
                             f"{dist} apart (tol {RESCALE_PARAMS})")
    say("rescale", f"{cfg.name} bf16 B={REC_B} S={REC_S}: {big} 4 ranks steps 0-1, saved; "
                   f"restored on {small} (2 ranks; every block of {checked[0]} leaves bit for "
                   f"bit the saved tree's, on each rank) step 2, saved; restored on {back} "
                   f"step 3.  Losses uninterrupted {[round(x, 6) for x in straight]}, re-scaled "
                   f"steps 2-3 {[round(x, 6) for x in resc]}: gaps {gaps[0]:.2e}, "
                   f"{gaps[1]:.2e} (tol {RESCALE_LOSS}); final parameters at most {dist:.4f} "
                   f"from the uninterrupted world's (tol {RESCALE_PARAMS}) | {gpu}")
    for dims, ranks, wall in out:
        parts = []
        for i, leg_res in enumerate(ranks[0]):
            walls = _per_rank(leg_res["walls"])
            parts.append(f"leg {i}: step walls (s) [{walls}]")
            for key in ("restore_seconds", "check_seconds", "save_seconds",
                        "save_params_seconds"):
                if key in leg_res:
                    parts.append(f"{key.replace('_seconds', '')} (s) a rank "
                                 f"[{_per_rank([r[i][key] for r in ranks])}]")
            parts.append(f"peak memory (GB) a rank "
                         f"[{_per_rank([r[i]['peak_bytes'] / 1e9 for r in ranks])}]")
        say("rescale", f"world {dims} ({math.prod(dims)} gloo ranks on the card): "
                       f"{'; '.join(parts)}; world wall {wall:.1f} s | {gpu}")


def phase_drill_evidence(gpu: str) -> None:
    """13(c): ``host_drop_drill()`` gives the CPU's evidence dict."""
    from repro_torch.runtime import host_drop_drill

    fresh_planner()
    ev = host_drop_drill()
    import hashlib

    digest = hashlib.sha256(json.dumps(ev, sort_keys=True).encode()).hexdigest()
    picked = {k: ev[k] for k in DRILL_EVIDENCE}
    if digest != DRILL_EVIDENCE_SHA or picked != DRILL_EVIDENCE:
        raise AssertionError(f"host_drop_drill evidence differs from the CPU's: "
                             f"{json.dumps(ev, sort_keys=True)}")
    say("recovery", f"host_drop_drill evidence equals the CPU's (sha256 {digest[:16]}): "
                    f"{picked}, backoff delays {ev['backoff_delays']} | {gpu}")
    fresh_planner()


def phase_mesh_drills(gpu: str, one_card_lines: list) -> None:
    """13(d): serve's degradation and shed drills on mesh (2, 1) at full
    width, against the same world's run without them and phase 10's
    one-device lines."""
    from repro_torch.launch import serve

    cfg = serve_config(DRILL_ARCH)
    B, P, N = B_SERVE, P_SERVE, N_SERVE
    kw = dict(batch=B, prompt_len=P, new_tokens=N, seed=0, device="cuda",
              mesh_shape=MESH_DRILL)
    plain, drilled = [], []
    fresh_planner()
    gc.collect()
    torch.cuda.empty_cache()
    base = serve.run(cfg, report=plain, **kw)
    gen = serve.run(cfg, degrade_at=DEGRADE_AT, fail_at=FAIL_AT, fail_mode="shed",
                    report=drilled, **kw)
    check_shed("mesh shed", gen, B, FAIL_AT)
    if not np.array_equal(gen[:B - 1], base[:B - 1]):
        raise AssertionError(f"mesh shed: rows 0..{B - 2} differ from the run without drills")
    not_plan = lambda lines: [ln for ln in lines if DRILL_LINE.match(ln)  # noqa: E731
                              and not ln.startswith("[serve] per-step plan")]
    lines = [not_plan(r["lines"]) for r in drilled]
    if any(ln != not_plan(one_card_lines) for ln in lines):
        raise AssertionError(f"mesh drill lines {lines} differ from phase 10's "
                             f"{not_plan(one_card_lines)}")
    counters = [r["metrics"]["counters"] for r in drilled]
    if any(c != counters[0] for c in counters):
        raise AssertionError(f"the ranks' counters differ: {counters}")
    for ln in (l for l in drilled[0]["lines"] if DRILL_LINE.match(l)):
        say("recovery", f"mesh {MESH_DRILL}: {ln}")
    steps = drilled[0]["step_seconds"]
    say("recovery", f"{cfg.name} B={B} prompt={P} new={N} over {len(drilled)} gloo ranks (mesh "
                    f"{MESH_DRILL}), degradation at step {DEGRADE_AT}, a shed at {FAIL_AT}: "
                    f"drill lines equal phase 10's one-device ones but for the plan; rows "
                    f"0..{B - 2} equal the run without drills; every rank's counters alike; "
                    f"eager steps (ms) {_per_rank([x * 1e3 for x in steps], '{:.2f}')}; without "
                    f"drills median {statistics.median(plain[0]['step_seconds']) * 1e3:.2f} ms; "
                    f"flash launches a rank {[r['launches']['flash_attention'][0] for r in drilled]}"
                    f"; peak memory a rank (GB) "
                    f"{_per_rank([r['peak_bytes'] / 1e9 for r in drilled])} | {gpu}")
    fresh_planner()


# the dry-run's cells in phase 14's child, each with the reference's own
# per-rank dot FLOPs (its GSPMD splits the products over "model", RWKV's
# time-mix and channel-mix and the RG-LRU block too, and long_500k's over
# "data" as well; tests/test_torch_dryrun.py holds the port to them)
DRYRUN_CELLS = {("llama3.2-1b", "decode_32k", "single"): 3.41678e9,
                ("rwkv6-1.6b", "decode_32k", "single"): 1.45228e9,
                ("recurrentgemma-9b", "decode_32k", "single"): 9.21117568e9,
                ("gemma2-9b", "long_500k", "single"): 7.87161e8,
                ("recurrentgemma-9b", "long_500k", "single"): 7.20118e7}
DRYRUN_TIMEOUT = 300.0
# the child: each cell through the dry-run's CLI, one process
_DRYRUN_CHILD = """
import json, sys
from repro_torch.launch import dryrun
out = sys.argv[1]
for arch, shape, mesh in json.loads(sys.argv[2]):
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out])
"""
COUNT_ARCH, COUNT_B, COUNT_P = "llama3.2-1b", 4, 512
COUNT_TOL = 0.01  # the counter's matmul FLOPs against torch.profiler's
MATMUL_EVENTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def dryrun_cells() -> tuple:
    """({cell: its record} of ``DRYRUN_CELLS`` from ``repro_torch.launch.dryrun``
    in one child process, the child's seconds)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run([sys.executable, "-c", _DRYRUN_CHILD, out,
                               json.dumps(list(DRYRUN_CELLS))],
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=DRYRUN_TIMEOUT)
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {list(DRYRUN_CELLS)} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        recs = {}
        for cell in DRYRUN_CELLS:
            with open(os.path.join(out, "__".join(cell) + "__baseline.json")) as f:
                recs[cell] = json.load(f)
        return recs, time.perf_counter() - t0


def counted_prefill(cfg, params, tokens) -> tuple:
    """(the cost counter's count, torch.profiler's matmul FLOPs) of one
    prefill of ``tokens``, counted and profiled as two calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.hlo_analysis import trace_cost
    from repro_torch.models import steps

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if tokens.is_cuda else [])
    with torch.no_grad():
        counted = trace_cost(steps.prefill_step, cfg, params, tokens)
        with profile(activities=acts, with_flops=True) as prof:
            steps.prefill_step(cfg, params, tokens)
            if tokens.is_cuda:
                torch.cuda.synchronize()
    return counted, sum(e.flops for e in prof.key_averages() if e.key in MATMUL_EVENTS)


def phase_dryrun(gpu: str, cells: concurrent.futures.Future | None = None) -> None:
    """Phase 14: the dry-run and the cost counter (see the module docstring).
    ``cells``: :func:`dryrun_cells` already started (``main`` starts it
    beside phase 2's build, whose time is not a result), else started
    here."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import use_kernels
    from repro_torch.launch.hlo_analysis import trace_cost
    from repro_torch.models import steps
    from repro_torch.models.transformer import init_params

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        if cells is None:  # the child traces on the host while the card counts
            cells = pool.submit(dryrun_cells)
        cfg = get_config(COUNT_ARCH)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (COUNT_B, COUNT_P))
                                  .astype(np.int32)).cuda()
        use_kernels(False)
        counted, prof_flops = counted_prefill(cfg, params, tokens)
        got = counted.cost.dot_flops
        rel = abs(got - prof_flops) / prof_flops
        model = 2 * cfg.param_count() * COUNT_B * COUNT_P
        say("dryrun", f"{COUNT_ARCH} prefill B={COUNT_B} prompt={COUNT_P} bf16 on the card, "
                      f"kernels off: the counter's dot_flops {got:.6g}, torch.profiler's matmul "
                      f"FLOPs {prof_flops:.6g} (rel {rel:.2e}, gate {COUNT_TOL}), 2·N·tokens "
                      f"{model:.6g}; hbm_bytes {counted.cost.hbm_bytes:.6g}, all FLOPs "
                      f"{counted.flops:.6g}, temp bytes {counted.temp_bytes:.6g} | {gpu}")
        if not rel <= COUNT_TOL:
            raise AssertionError(f"the counter's matmul FLOPs {got:.6g} differ from the "
                                 f"profiler's {prof_flops:.6g} by {rel:.2e} > {COUNT_TOL}")
        use_kernels(True)
        try:
            with torch.no_grad():
                trace_cost(steps.prefill_step, cfg, params, tokens)
        except RuntimeError as e:
            if "kernels launched while counting" not in str(e):
                raise
            say("dryrun", f"with the kernels on the counter refuses: {str(e)[:160]}")
        else:
            raise AssertionError("the counter counted a prefill that launched kernels")
        finally:
            use_kernels(False)
        recs, t_cells = cells.result()
    for cell, ref in DRYRUN_CELLS.items():
        rec = recs[cell]
        hc = rec.get("hlo_cost", {})
        split = hc.get("dot_flops", 0) / ref
        if rec.get("ok") is not True or not abs(split - 1) <= COUNT_TOL:
            raise AssertionError(f"dryrun {cell}: dot_flops {split:.4f} x the reference's "
                                 f"{ref:.6g}; record {json.dumps(rec)[:2000]}")
        axes = "'model' and 'data'" if cell[1] == "long_500k" else "'model'"
        say("dryrun", f"{'/'.join(cell)} over 256 fake ranks in a child process "
                      f"({t_cells:.1f} s for {len(DRYRUN_CELLS)} cells, trace_s "
                      f"{rec['trace_s']}): per rank dot_flops, split over {axes}, "
                      f"{hc['dot_flops']:.6g} ({split:.4f} x the reference's {ref:.6g}), "
                      f"collectives "
                      f"{ {k: v['count'] for k, v in hc['collectives'].items() if v.get('count')} }"
                      f", hbm_bytes {hc['hbm_bytes']:.6g}, ICI bytes "
                      f"{hc['collective_ici_bytes']:.6g}, DCN bytes "
                      f"{hc['collective_dcn_bytes']:.6g}, argument bytes "
                      f"{rec['memory']['argument_bytes']:.6g}, temp bytes "
                      f"{rec['memory']['temp_bytes']:.6g}; JAX in this process: "
                      f"{'jax' in sys.modules} | {gpu}")
    del params, tokens, counted
    gc.collect()
    torch.cuda.empty_cache()
    say("dryrun", f"ok in {time.perf_counter() - t0:.1f} s")


def phase_recovery(gpu: str, one_card_lines: list) -> None:
    """Phase 13: recovery and elastic re-scale (see the module docstring)."""
    t0 = time.perf_counter()
    phase_recovery_full(gpu)
    phase_rescale(gpu)
    phase_drill_evidence(gpu)
    phase_mesh_drills(gpu, one_card_lines)
    say("recovery", f"ok in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    walls = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    gpu = timed("1 device", phase_device)
    # phase 14's child traces its cells on the host beside the kernels' build
    early = concurrent.futures.ThreadPoolExecutor(1)
    cells = early.submit(dryrun_cells)
    timed("2 build", phase_build)
    fa_errs = timed("3 kernels (flash)", phase_kernel_cases)
    wkv_err, wkv_parts = timed("3 kernels (wkv6)", phase_wkv_cases)
    lru_err = timed("3 kernels (rglru)", phase_lru_cases)
    timed("4 parity", lambda: [phase_parity(arch) for arch in ARCHS])
    served = timed("5 serve", lambda: {arch: phase_serve(gpu, arch) for arch in ARCHS})
    launches = {arch: counts for arch, (counts, _) in served.items()}
    in_encoder = {arch: enc for arch, (_, enc) in served.items()}
    timed("5 ring", phase_ring, gpu)
    timed("6 breakdown", lambda: [phase_breakdown(gpu, arch) for arch in ARCHS])
    rows = timed("7 timing", lambda: [phase_timing(gpu, launches, in_encoder, fa_errs),
                                      phase_wkv_timing(gpu, launches, wkv_err, wkv_parts),
                                      phase_lru_timing(gpu, launches, lru_err)])
    timed("8 train", phase_train, gpu)
    shed_lines = timed("10 drills", phase_drills, gpu)
    timed("9 fit", phase_fit, gpu)
    timed("11 collectives", phase_collectives, gpu)
    timed("12 ranks", phase_ranks, gpu)
    timed("13 recovery", phase_recovery, gpu, shed_lines)
    timed("14 dryrun", phase_dryrun, gpu, cells)
    early.shutdown()
    say("time", f"phase walls (s) {', '.join(f'{k} {v:.1f}' for k, v in walls.items())}; "
                f"the script {time.perf_counter() - t_start:.1f} s | {gpu}")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

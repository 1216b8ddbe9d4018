"""The port's serving path against the JAX package's, on JAX's own weights.

Smoke llama3.2-1b, rwkv6-1.6b, recurrentgemma-9b, olmo-1b, codeqwen1.5-7b,
gemma2-9b, whisper-small and llama-3.2-vision-11b (with a frontend drawn
with numpy, and every XATTN gate set non-zero), mixtral-8x22b and dbrx-132b
(the MoE layer on the dense path): JAX ``prefill`` + 8
``decode_step``s against the port's, on the same weights
(``params_from_jax``) and prompts.  In f32 the logits agree to 1e-4 (the
sums run in another order through the layers and the head), the greedy
tokens are identical and the caches (KV cache, ring-buffer KV cache; WKV
state and token shifts; RG-LRU state and conv tail) agree; once with
kernels off on both sides, once with JAX's Pallas kernels (interpret mode)
and the port's kernel switch on (CPU tensors take the plain versions).
rwkv6's kernels-on prompt is 64 tokens: JAX routes WKV to its Pallas kernel
only when the length is a multiple of the 32-token chunk; a ragged prompt
of 40 runs with kernels off.  recurrentgemma's and gemma2's prompt of 40 is
longer than their smoke window of 32, so each LOCAL layer's cache is a ring
that wraps during decode (gemma2's prompt of 128 fills the ring from a
prompt four times its size); so is mixtral's.  In bf16 the logits agree to 5e-2 (bf16 rounds at other
places in the two frameworks; rwkv6 and recurrentgemma at 1e-1, for the
reasons their tests give), decoding the same tokens on both sides.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.kernels as jkernels
import repro.models.decode as jdec
import repro.models.moe as jmoe
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.kernels as tkernels
import repro_torch.models.decode as tdec
import repro_torch.models.moe as tmoe
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.launch import serve
from repro_torch.models.convert import draw_xattn_gates, params_from_jax, tree_map

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
RWKV = "rwkv6-1.6b"
GEMMA = "recurrentgemma-9b"
OLMO = "olmo-1b"
QWEN = "codeqwen1.5-7b"
GEMMA2 = "gemma2-9b"
WHISPER = "whisper-small"
VISION = "llama-3.2-vision-11b"
MIXTRAL = "mixtral-8x22b"
DBRX = "dbrx-132b"
B, P, STEPS = 2, 16, 8
# each layer kind's prefill kernel entry point (XATTN layers call none; each
# encoder layer calls flash)
KIND_OPS = {"attn": fa_ops, "local": fa_ops, "attn_x": fa_ops, "rwkv": wkv_ops,
            "rglru": lru_ops}


@pytest.fixture
def kernels_on(request):
    """Both kernel switches set to ``request.param``; restored afterwards
    (the switches are process-global and xdist workers share them)."""
    jkernels.use_pallas(request.param)
    tkernels.use_kernels(request.param)
    try:
        yield request.param
    finally:
        jkernels.use_pallas(False)
        tkernels.use_kernels(False)


def _setup(dtype, arch=ARCH, prompt_len=P):
    """Configs, JAX params, port params, prompts, and the frontend as (JAX,
    port) arrays in ``dtype`` (None, None without one).  XATTN gates start at
    zero, where the layer adds nothing: they are set to ±[0.3, 1.0) first."""
    jc = dataclasses.replace(jcfgs.smoke_config(arch), dtype=dtype)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), dtype=dtype)
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, jc.vocab_size, size=(B, prompt_len), dtype=np.int32)
    draw_xattn_gates(jp, rng)
    frontend = (None, None)
    if jc.frontend_tokens:
        fr = rng.standard_normal((B, jc.frontend_tokens, jc.frontend_dim or jc.d_model),
                                 dtype=np.float32)
        frontend = (jnp.asarray(fr, jnp.dtype(dtype)),
                    torch.from_numpy(fr).to(getattr(torch, dtype)))
    return jc, tc, jp, params_from_jax(jp), prompts, frontend


def _run(jc, tc, jp, tp, prompts, frontend=(None, None), *, teacher_forced):
    """Prefill + STEPS decode steps on both sides.  Each side decodes its own
    greedy pick, or both decode JAX's when ``teacher_forced``."""
    P = prompts.shape[1]
    cap = P + STEPS
    jpre = jax.jit(functools.partial(jdec.prefill, jc, capacity=cap))
    jstep = jax.jit(functools.partial(jdec.decode_step, jc))
    jlog, jcache = jpre(jp, jnp.asarray(prompts), frontend=frontend[0])
    tlog, tcache = tdec.prefill(tc, tp, torch.from_numpy(prompts), frontend=frontend[1],
                                capacity=cap)
    jlogs, tlogs, jtoks, ttoks = [jlog], [tlog], [], []
    for i in range(STEPS):
        jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)[:, None]
        ttok = torch.from_numpy(np.array(jtok)) if teacher_forced else tlog.argmax(-1)[:, None]
        jtoks.append(np.asarray(jtok)[:, 0])
        ttoks.append(ttok[:, 0].numpy())
        jlog, jcache = jstep(jp, jcache, jtok, jnp.int32(P + i))
        tlog, tcache = tdec.decode_step(tc, tp, tcache, ttok, P + i)
        jlogs.append(jlog)
        tlogs.append(tlog)
    return jlogs, tlogs, jtoks, ttoks, jcache, tcache


@pytest.mark.parametrize("arch,prompt_len,kernels_on", [
    pytest.param(ARCH, P, False, id="False"),
    pytest.param(ARCH, P, True, id="True"),
    pytest.param(RWKV, 64, False, id="rwkv6-1.6b-P64-False"),
    pytest.param(RWKV, 64, True, id="rwkv6-1.6b-P64-True"),
    pytest.param(RWKV, 40, False, id="rwkv6-1.6b-P40-False"),
    pytest.param(GEMMA, 16, False, id="recurrentgemma-9b-P16-False"),
    pytest.param(GEMMA, 16, True, id="recurrentgemma-9b-P16-True"),
    pytest.param(GEMMA, 40, False, id="recurrentgemma-9b-P40-False"),
    pytest.param(GEMMA, 40, True, id="recurrentgemma-9b-P40-True"),
    pytest.param(OLMO, 16, False, id="olmo-1b-P16-False"),
    pytest.param(OLMO, 16, True, id="olmo-1b-P16-True"),
    pytest.param(QWEN, 16, False, id="codeqwen1.5-7b-P16-False"),
    pytest.param(QWEN, 16, True, id="codeqwen1.5-7b-P16-True"),
    pytest.param(GEMMA2, 40, False, id="gemma2-9b-P40-False"),
    pytest.param(GEMMA2, 40, True, id="gemma2-9b-P40-True"),
    pytest.param(GEMMA2, 128, True, id="gemma2-9b-P128-True"),
    pytest.param(WHISPER, 16, False, id="whisper-small-P16-False"),
    pytest.param(WHISPER, 16, True, id="whisper-small-P16-True"),
    pytest.param(VISION, 16, False, id="llama-3.2-vision-11b-P16-False"),
    pytest.param(VISION, 16, True, id="llama-3.2-vision-11b-P16-True"),
    pytest.param(MIXTRAL, 16, False, id="mixtral-8x22b-P16-False"),
    pytest.param(MIXTRAL, 16, True, id="mixtral-8x22b-P16-True"),
    pytest.param(MIXTRAL, 40, False, id="mixtral-8x22b-P40-False"),
    pytest.param(MIXTRAL, 40, True, id="mixtral-8x22b-P40-True"),
    pytest.param(DBRX, 16, False, id="dbrx-132b-P16-False"),
    pytest.param(DBRX, 16, True, id="dbrx-132b-P16-True"),
], indirect=["kernels_on"])
def test_prefill_decode_f32_matches_jax(arch, prompt_len, kernels_on):
    jc, tc, jp, tp, prompts, frontend = _setup("float32", arch, prompt_len)
    all_ops = set(KIND_OPS.values())
    plain_before = {ops: ops.plain_calls for ops in all_ops}
    jlogs, tlogs, jtoks, ttoks, jcache, tcache = _run(jc, tc, jp, tp, prompts, frontend,
                                                      teacher_forced=False)
    # with the switch on, prefill took each layer's kernel route once, and
    # flash once more for each encoder layer
    kinds = [k for g in tc.groups for k in g.pattern * g.count]
    for ops in all_ops:
        want = sum(KIND_OPS.get(k) is ops for k in kinds) + (tc.encoder_layers if ops is fa_ops
                                                             else 0)
        assert ops.plain_calls - plain_before[ops] == (want if kernels_on else 0)
    for j, t in zip(jlogs, tlogs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    jl, jdef = jax.tree.flatten(jcache)
    tl, tdef = jax.tree.flatten(tcache)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)


def _check_bf16(arch, prompt_len=P, tol=5e-2):
    jc, tc, jp, tp, prompts, frontend = _setup("bfloat16", arch, prompt_len)
    jlogs, tlogs, _, ttoks, _, _ = _run(jc, tc, jp, tp, prompts, frontend, teacher_forced=True)
    for j, t in zip(jlogs, tlogs):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)
    return tc, tp, prompts, jlogs, tlogs, ttoks


def test_prefill_decode_bf16_matches_jax():
    _check_bf16(ARCH)


def test_prefill_decode_bf16_matches_jax_rwkv6():
    """rwkv6 at 1e-1, not llama's 5e-2: its three sigmoid gates per layer
    round differently in the two frameworks (JAX's bf16 sigmoid rounds each
    step of 1 / (1 + exp(-x)); torch's rounds once).  That is bf16's own
    noise on this model: each package's bf16 logits lie within 0.2 of the
    f32 logits of the same weights and tokens, and the port's lie no
    farther than JAX's."""
    tc, tp, prompts, jlogs, tlogs, ttoks = _check_bf16(RWKV, prompt_len=40, tol=1e-1)
    tc32 = dataclasses.replace(tc, dtype="float32")
    tp32 = tree_map(lambda t: t.float(), tp)
    P = prompts.shape[1]
    lg, cache = tdec.prefill(tc32, tp32, torch.from_numpy(prompts), capacity=P + STEPS)
    refs = [lg]
    for i, tok in enumerate(ttoks):
        lg, cache = tdec.decode_step(tc32, tp32, cache, torch.from_numpy(tok)[:, None], P + i)
        refs.append(lg)
    err = {side: max(float(np.abs(np.asarray(a, np.float32) - r.numpy()).max())
                     for a, r in zip(logs, refs))
           for side, logs in (("jax", jlogs), ("port", tlogs))}
    assert err["port"] <= err["jax"] < 0.2, err


def _check_bf16_against_f32(arch, prompt_len, bound=0.1):
    """bf16 logits of both packages at 1e-1, each within ``bound`` of the f32
    logits of the same weights and tokens, their mean distances to them
    within 10% of each other."""
    tc, tp, prompts, jlogs, tlogs, ttoks = _check_bf16(arch, prompt_len, tol=1e-1)
    tc32 = dataclasses.replace(tc, dtype="float32")
    tp32 = tree_map(lambda t: t.float(), tp)
    lg, cache = tdec.prefill(tc32, tp32, torch.from_numpy(prompts),
                             capacity=prompt_len + STEPS)
    refs = [lg]
    for i, tok in enumerate(ttoks):
        lg, cache = tdec.decode_step(tc32, tp32, cache, torch.from_numpy(tok)[:, None],
                                     prompt_len + i)
        refs.append(lg)
    dist = {side: [np.abs(np.asarray(a, np.float32) - r.numpy()) for a, r in zip(logs, refs)]
            for side, logs in (("jax", jlogs), ("port", tlogs))}
    worst = {side: max(float(d.max()) for d in ds) for side, ds in dist.items()}
    mean = {side: float(np.mean([d.mean() for d in ds])) for side, ds in dist.items()}
    assert max(worst.values()) < bound, worst
    assert abs(mean["port"] / mean["jax"] - 1) < 0.1, mean
    return worst, mean


@pytest.mark.parametrize("prompt_len", [16, 40])
def test_prefill_decode_bf16_matches_jax_recurrentgemma(prompt_len):
    """recurrentgemma at 1e-1, not llama's 5e-2: JAX's bf16 GeLU (tanh form,
    in the RG-LRU gate and the GeGLU MLP of every layer) rounds each step of
    its formula, torch's rounds once, and 1 of 1024 logits lands 0.06 apart.
    That is bf16's own noise on this model: each package's bf16 logits lie
    within 0.1 of the f32 logits of the same weights and tokens, and their
    mean distances to them agree within 10% (0.0099 for both at prompt 16,
    0.0111 for the port and 0.0106 for JAX at prompt 40; the port's largest
    distance is the smaller one at prompt 40, the larger at prompt 16)."""
    _check_bf16_against_f32(GEMMA, prompt_len)


def test_prefill_decode_bf16_matches_jax_gemma2():
    """gemma2 held as recurrentgemma is: its GeGLU MLP takes the same bf16
    tanh-GeLU, which JAX rounds at each step of the formula and torch once.
    Prompt 40 wraps the LOCAL layers' ring of 32.  Largest distances to the
    f32 logits 0.039 (port) and 0.037 (JAX), means 0.0077 and 0.0076."""
    _check_bf16_against_f32(GEMMA2, 40)


@pytest.mark.parametrize("arch,prompt_len,bound", [(MIXTRAL, 40, 0.1), (DBRX, 16, 0.25)])
def test_prefill_decode_bf16_matches_jax_moe(arch, prompt_len, bound):
    """The MoE models held as recurrentgemma is.  In bf16 a router logit
    moves by a rounding, so a token whose k-th and (k+1)-th expert are that
    close may pick another expert and move its logits by O(0.1).  Each
    package's bf16 logits lie within ``bound`` of the f32 logits of the same
    weights and tokens (dbrx's bf16 prefill sends 2 of its first layer's 64
    (token, slot) routes elsewhere than its f32 prefill, in both packages
    alike, and its decode logits land up to 0.20 from the f32 ones;
    mixtral's bf16 and f32 routes agree, and its logits lie within 0.072),
    their mean distances agree within 10% (JAX 0.0087 and port 0.0088 for
    mixtral, 0.0191 and 0.0193 for dbrx), and at least 95% of the (token,
    slot) routes of the two packages' bf16 prefills agree (all of them at
    these seeds)."""
    _check_bf16_against_f32(arch, prompt_len, bound)
    jc, tc, jp, tp, prompts, _ = _setup("bfloat16", arch, prompt_len)
    routes = {"jax": [], "port": []}
    route = {"jax": jmoe._route, "port": tmoe._route}

    def recording(side, to_numpy):
        def rec(cfg, router_w, x):
            gates, idx, aux = route[side](cfg, router_w, x)
            routes[side].append(np.sort(to_numpy(idx), axis=-1))
            return gates, idx, aux
        return rec

    jmoe._route, tmoe._route = recording("jax", np.asarray), recording("port", torch.Tensor.numpy)
    try:
        with jax.disable_jit():  # the reference's layer scan runs eagerly: idx are values
            jdec.prefill(jc, jp, jnp.asarray(prompts), capacity=prompt_len)
        tdec.prefill(tc, tp, torch.from_numpy(prompts), capacity=prompt_len)
    finally:
        jmoe._route, tmoe._route = route["jax"], route["port"]
    assert len(routes["jax"]) == len(routes["port"]) == tc.n_layers
    agree = np.mean([np.mean(j == t) for j, t in zip(routes["jax"], routes["port"])])
    assert agree >= 0.95, agree


def test_serve_run_equals_main():
    """``main`` parses the flags and serves the config through ``run``: the
    same generations for the same seed."""
    gen = serve.main(["--arch", MIXTRAL, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "40", "--new-tokens", "6", "--seed", "3"])
    again = serve.run(tcfgs.smoke_config(MIXTRAL), batch=2, prompt_len=40, new_tokens=6,
                      seed=3, device="cpu")
    assert gen.shape == (2, 6) and gen.dtype == np.int32
    np.testing.assert_array_equal(gen, again)
    assert not tkernels.kernels_enabled()


def test_serve_main_cpu_recurrentgemma():
    """The recurrentgemma smoke model through serve's CLI: each LOCAL layer
    took the flash kernel's entry point and each RGLRU layer the RG-LRU
    scan's, which on the CPU are the plain versions."""
    cfg = tcfgs.smoke_config(GEMMA)
    kinds = [k for g in cfg.groups for k in g.pattern * g.count]
    before = (fa_ops.plain_calls, lru_ops.plain_calls)
    gen = serve.main(["--arch", GEMMA, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 32) and gen.dtype == np.int32
    assert 0 <= gen.min() and gen.max() < cfg.vocab_size
    assert (fa_ops.plain_calls - before[0], lru_ops.plain_calls - before[1]) == (
        kinds.count("local"), kinds.count("rglru"))
    assert not tkernels.kernels_enabled()


def test_serve_main_cpu_rwkv6():
    """The rwkv6 smoke model through serve's CLI: WKV took the kernel's
    entry point once per layer, which on the CPU is the plain version."""
    before = wkv_ops.plain_calls
    gen = serve.main(["--arch", RWKV, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 32) and gen.dtype == np.int32
    assert 0 <= gen.min() and gen.max() < tcfgs.smoke_config(RWKV).vocab_size
    assert wkv_ops.plain_calls - before == tcfgs.smoke_config(RWKV).n_layers
    assert not tkernels.kernels_enabled()


def test_serve_main_cpu_end_to_end_is_seeded(tmp_path):
    argv = ["--smoke", "--device", "cpu", "--batch", "3", "--prompt-len", "12",
            "--new-tokens", "5", "--seed", "7"]
    trace_path = tmp_path / "serve.json"
    gen1 = serve.main(argv + ["--trace", str(trace_path)])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gen2 = serve.main(argv)
    assert gen1.shape == (3, 5) and gen1.dtype == np.int32
    assert gen1.min() >= 0 and gen1.max() < tcfgs.smoke_config(ARCH).vocab_size
    np.testing.assert_array_equal(gen1, gen2)
    assert not tkernels.kernels_enabled()  # serve restores the switch
    names = [e["name"] for e in json.loads(trace_path.read_text())["traceEvents"]]
    ranges = [e.name for e in prof.events()]  # spans are profiler ranges too
    for got in (names, ranges):
        assert (got.count("prefill"), got.count("decode"), got.count("decode.step")) == (1, 1, 5)


def test_params_from_jax_bf16_round_trip_is_bit_exact():
    jc = jcfgs.smoke_config(ARCH)  # bfloat16
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree)
    back = tree_map(lambda t: t.float().numpy().astype(ml_dtypes.bfloat16), tp)
    a_leaves, a_def = jax.tree.flatten(np_tree)
    b_leaves, b_def = jax.tree.flatten(back)
    assert a_def == b_def
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(tp))
    for a, b in zip(a_leaves, b_leaves):
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))

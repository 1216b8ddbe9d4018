"""Cross-attention and the encoder: whisper-small and llama-3.2-vision-11b
against the JAX package, on JAX's own weights.

Smoke widths, weights from ``repro.models.init_params`` carried across by
``params_from_jax``, prompts and frontend embeddings drawn with numpy.
Every XATTN layer's ``gate_attn`` and ``gate_mlp`` start at zero (tanh(0) =
0: the layer would add nothing and hide a wrong cross-attention), so the
tests set them to values in ±[0.3, 1.0) drawn from the seed, in the JAX
tree before it is carried across.  f32 at 1e-4 (the sums run in another
order); bf16 logits at 1e-1 for whisper, whose tanh-GeLU JAX rounds at each
step of the formula and torch once (both within 0.1 of the f32 logits of
the same weights, their mean distances to them within 10%), and at 5e-2 for
llama-vision (SiLU, RMSNorm), as for llama.  With kernels on, the JAX
package runs its Pallas flash kernel in interpret mode (non-causal in the
encoder: 24 frames make one 24-row block) and the port's CPU tensors take
the kernel's plain version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.kernels as jkernels
import repro.launch.serve as jserve
import repro.models.attention as jattn
import repro.models.decode as jdec
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.kernels as tkernels
import repro_torch.models.attention as tattn
import repro_torch.models.decode as tdec
import repro_torch.models.transformer as ttf
from repro.kernels.flash_attention import ops as jfa_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models.convert import draw_xattn_gates, params_from_jax, tree_map

torch.set_num_threads(1)

WHISPER, VISION = "whisper-small", "llama-3.2-vision-11b"
ARCHS = [WHISPER, VISION]
B, P, STEPS = 2, 16, 4
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = {WHISPER: 1e-1, VISION: 5e-2}


@pytest.fixture
def kernels_on(request):
    """Both kernel switches set to ``request.param``; restored afterwards."""
    jkernels.use_pallas(request.param)
    tkernels.use_kernels(request.param)
    try:
        yield request.param
    finally:
        jkernels.use_pallas(False)
        tkernels.use_kernels(False)


def _setup(arch, dtype, seed=0):
    """(JAX config, port config, JAX params, port params, prompts, JAX
    frontend, port frontend): the same weights, gates set non-zero."""
    jc = dataclasses.replace(jcfgs.smoke_config(arch), dtype=dtype)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), dtype=dtype)
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(seed))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    assert draw_xattn_gates(jp, rng) == (2 if arch == VISION else 0)
    prompts = rng.integers(2, jc.vocab_size, size=(B, P), dtype=np.int32)
    fr = rng.standard_normal((B, jc.frontend_tokens, jc.frontend_dim or jc.d_model),
                             dtype=np.float32)
    jfr = jnp.asarray(fr, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tfr = torch.from_numpy(fr).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jc, tc, jp, params_from_jax(jp), prompts, jfr, tfr


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# Cross-attention alone.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T", [24, 2100], ids=["dense", "chunked"])
def test_cross_kv_and_cross_attention_match_reference(T):
    """B=1 at the vision smoke width (128 wide, 4 query heads over 2 KV heads
    of 32, K/V projected from 64-wide frontend states).  T=2100 is above
    CHUNK_THRESHOLD, so both packages take the KV-chunked online softmax
    (with a ragged last chunk); T=24 the dense softmax."""
    assert (T > jattn.CHUNK_THRESHOLD) == (T > tattn.CHUNK_THRESHOLD)
    jc = dataclasses.replace(jcfgs.smoke_config(VISION), dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(VISION), dtype="float32")
    jp = jax.tree.map(np.asarray, jattn.attn_params(jc, jax.random.PRNGKey(3),
                                                    kv_input_dim=jc.frontend_dim))
    tp = params_from_jax(jp)
    assert tuple(tp["wk"].shape) == (jc.frontend_dim, jc.n_kv_heads, jc.head_dim_)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 5, jc.d_model), dtype=np.float32)
    enc = rng.standard_normal((1, T, jc.frontend_dim), dtype=np.float32)
    jk, jv = jattn.cross_kv(jc, jp, jnp.asarray(enc))
    tk, tv = tattn.cross_kv(tc, tp, torch.from_numpy(enc))
    _close(tk, jk)
    _close(tv, jv)
    want = jattn.cross_attention(jc, jp, jnp.asarray(x), (jk, jv))
    got = tattn.cross_attention(tc, tp, torch.from_numpy(x), (tk, tv))
    assert got.shape == (1, 5, jc.d_model)
    _close(got, want)


# --------------------------------------------------------------------------
# The encoder.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
def test_run_encoder_matches_reference(kernels_on):
    """whisper's encoder at 24 frames in f32: learned positions, two layers
    of bidirectional self-attention and GeLU MLP behind LayerNorms.  With
    kernels on, the JAX package's attention is its Pallas kernel (24 frames
    make one supported block), non-causal, in interpret mode, and each port
    layer calls the flash kernel's entry point once (the plain version on
    the CPU)."""
    jc, tc, jp, tp, _, jfr, tfr = _setup(WHISPER, "float32")
    assert jfa_ops.supported(jc.frontend_tokens, jc.frontend_tokens, jc.head_dim_)
    before = fa_ops.plain_calls
    want = jax.jit(jtf._run_encoder, static_argnums=0)(jc, jp, jfr)
    got = ttf._run_encoder(tc, tp, tfr)
    assert fa_ops.plain_calls - before == (tc.encoder_layers if kernels_on else 0)
    assert got.shape == (B, jc.frontend_tokens, jc.d_model)
    _close(got, want)


def test_encoder_param_tree_matches_reference():
    """The port's own init of both archs: the same keys (``encoder`` with its
    stacked layers, final norm and positions; ATTNX's ``ln_x`` and
    ``xattn``; XATTN's 0-d gates at zero), shapes and dtypes as JAX's."""
    for arch in ARCHS:
        jc = jcfgs.smoke_config(arch)
        jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
        own = ttf.init_params(tcfgs.smoke_config(arch), torch.Generator().manual_seed(0))
        jl, jdef = jax.tree.flatten(jp)
        tl, tdef = jax.tree.flatten(own)
        assert jdef == tdef
        for a, t in zip(jl, tl):
            assert tuple(a.shape) == tuple(t.shape)
            assert str(a.dtype) == str(t.dtype).split(".")[1]
    layer = own["groups"][0][4]  # llama-vision's XATTN layer
    assert layer["gate_attn"].dtype == torch.float32
    assert float(layer["gate_attn"].abs().sum() + layer["gate_mlp"].abs().sum()) == 0.0


# --------------------------------------------------------------------------
# The whole model: forward, prefill and decode.
# --------------------------------------------------------------------------

def _serve_both(jc, tc, jp, tp, prompts, jfr, tfr):
    """JAX and port: forward, then prefill + STEPS decode steps, each side
    decoding JAX's greedy pick.  Returns forward's logits of both, and
    prefill's and each step's."""
    cap = P + STEPS
    jfwd, _ = jax.jit(functools.partial(jtf.forward, jc))(jp, jnp.asarray(prompts), frontend=jfr)
    tfwd, aux = ttf.forward(tc, tp, torch.from_numpy(prompts), frontend=tfr)
    assert float(aux) == 0.0
    jpre = jax.jit(functools.partial(jdec.prefill, jc, capacity=cap))
    jstep = jax.jit(functools.partial(jdec.decode_step, jc))
    jlog, jcache = jpre(jp, jnp.asarray(prompts), frontend=jfr)
    tlog, tcache = tdec.prefill(tc, tp, torch.from_numpy(prompts), frontend=tfr, capacity=cap)
    jlogs, tlogs = [jlog], [tlog]
    for i in range(STEPS):
        jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)[:, None]
        jlog, jcache = jstep(jp, jcache, jtok, jnp.int32(P + i))
        tlog, tcache = tdec.decode_step(tc, tp, tcache, torch.from_numpy(np.array(jtok)), P + i)
        jlogs.append(jlog)
        tlogs.append(tlog)
    return (jfwd, tfwd), jlogs, tlogs


@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32_matches_reference(arch, kernels_on):
    """f32 at 1e-4: ``forward``'s logits at every position, and no auxiliary
    loss.  With kernels on, each ATTN / ATTNX layer and each encoder layer
    took the flash kernel's entry point once; XATTN layers never.  Prefill,
    decode and the caches are held to the JAX package in
    ``test_torch_serve.py::test_prefill_decode_f32_matches_jax``."""
    jc, tc, jp, tp, prompts, jfr, tfr = _setup(arch, "float32")
    before = fa_ops.plain_calls
    want = jax.jit(functools.partial(jtf.forward, jc))(jp, jnp.asarray(prompts), frontend=jfr)[0]
    got, aux = ttf.forward(tc, tp, torch.from_numpy(prompts), frontend=tfr)
    kinds = [k for g in tc.groups for k in g.pattern * g.count]
    per_pass = sum(k in ("attn", "attn_x") for k in kinds) + tc.encoder_layers
    assert fa_ops.plain_calls - before == (per_pass if kernels_on else 0)
    assert float(aux) == 0.0
    assert got.shape == (B, P, tc.vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_bf16_match_reference(arch):
    """bf16 with a bf16 frontend, as serve runs: logits at 1e-1 (whisper) or
    5e-2 (llama-vision).  whisper's are also held to the f32 logits of the
    same weights, tokens and frontend: both packages within 0.1, their mean
    distances within 10% of each other."""
    tol = BF16_TOL[arch]
    jc, tc, jp, tp, prompts, jfr, tfr = _setup(arch, "bfloat16")
    (jfwd, tfwd), jlogs, tlogs = _serve_both(jc, tc, jp, tp, prompts, jfr, tfr)
    assert tfwd.dtype == torch.float32
    _close(tfwd, jfwd, atol=tol, rtol=tol)
    for j, t in zip(jlogs, tlogs):
        assert t.dtype == torch.float32
        _close(t, j, atol=tol, rtol=tol)
    if arch != WHISPER:
        return
    tc32 = dataclasses.replace(tc, dtype="float32")
    tp32 = tree_map(lambda t: t.float(), tp)
    lg, cache = tdec.prefill(tc32, tp32, torch.from_numpy(prompts), frontend=tfr.float(),
                             capacity=P + STEPS)
    refs = [lg]
    for i, j in enumerate(jlogs[:-1]):
        tok = torch.from_numpy(np.asarray(jnp.argmax(j, -1), np.int64))[:, None]
        lg, cache = tdec.decode_step(tc32, tp32, cache, tok, P + i)
        refs.append(lg)
    dist = {side: [np.abs(np.asarray(a, np.float32) - r.numpy()) for a, r in zip(logs, refs)]
            for side, logs in (("jax", jlogs), ("port", [t.numpy() for t in tlogs]))}
    worst = {side: max(float(d.max()) for d in ds) for side, ds in dist.items()}
    mean = {side: float(np.mean([d.mean() for d in ds])) for side, ds in dist.items()}
    assert max(worst.values()) < 0.1, worst
    assert abs(mean["port"] / mean["jax"] - 1) < 0.1, mean


# --------------------------------------------------------------------------
# What the port admits, and serve.
# --------------------------------------------------------------------------

def _port_config(jc):
    """A JAX package config as the port's ModelConfig (same fields)."""
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(tcfgs.ModelConfig)}
    fields["groups"] = tuple(tcfgs.LayerGroup(g.pattern, g.count) for g in jc.groups)
    return tcfgs.ModelConfig(**fields)


def test_check_supported_admits_both_and_refuses_mixtral():
    """Both archs are taken, and since the MoE layer is ported, mixtral too;
    mixtral with a layer kind the port does not know is refused."""
    assert len(tcfgs.ARCHS) == 10
    for arch in ARCHS:
        cfg = tcfgs.get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfgs.get_config(arch))
        assert dataclasses.asdict(tcfgs.smoke_config(arch)) == dataclasses.asdict(
            jcfgs.smoke_config(arch))
        ttf.check_supported(cfg)
    mixtral = _port_config(jcfgs.get_config("mixtral-8x22b"))
    assert mixtral.is_moe
    ttf.check_supported(mixtral)
    with pytest.raises(NotImplementedError):
        ttf.check_supported(dataclasses.replace(
            mixtral, groups=(tcfgs.LayerGroup(pattern=("local", "ssm"), count=2),)))


class _Frontend(Exception):
    """Raised by a stand-in prefill to hand out the frontend it was given."""


def _frontend_of(module, monkeypatch, argv, as_array):
    def fake_prefill(*args, frontend=None, **kwargs):
        raise _Frontend(as_array(frontend))

    monkeypatch.setattr(module, "prefill", fake_prefill)
    with pytest.raises(_Frontend) as got:
        if module is jdec:
            with jax.disable_jit():  # the jitted prefill runs as Python: concrete values
                jserve.main(argv)
        else:
            serve.main(argv)
    return got.value.args[0]


@pytest.mark.parametrize("arch,seed", [(WHISPER, 0), (VISION, 5)])
def test_serve_frontend_stub_is_the_reference_draw(arch, seed, monkeypatch):
    """The frontend each serve passes to prefill, bit for bit: the port's
    ``frontend_stub``, drawn after the prompts from the same numpy
    generator, equals the JAX package's bf16 draw for one ``--seed``."""
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len", "8", "--new-tokens",
            "2", "--seed", str(seed)]
    want = _frontend_of(jdec, monkeypatch, argv,
                        lambda f: np.asarray(f).view(np.uint16))
    got = _frontend_of(tdec, monkeypatch, argv + ["--device", "cpu"],
                       lambda f: f.view(torch.int16).numpy().view(np.uint16))
    cfg = tcfgs.smoke_config(arch)
    assert np.asarray(want).dtype == np.uint16
    assert got.shape == (3, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(seed)
    rng.integers(2, cfg.vocab_size, size=(3, 8), dtype=np.int32)
    stub = serve.frontend_stub(cfg, rng, 3, "cpu")
    assert stub.dtype == torch.bfloat16
    np.testing.assert_array_equal(stub.float().numpy(),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32))
    assert serve.frontend_stub(tcfgs.smoke_config("llama3.2-1b"), rng, 3, "cpu") is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_cpu(arch):
    """Each smoke model through serve's CLI with its frontend stub: every
    encoder layer and every ATTN or ATTNX layer took the flash kernel's
    entry point once (the plain version on the CPU), XATTN layers none."""
    cfg = tcfgs.smoke_config(arch)
    kinds = [k for g in cfg.groups for k in g.pattern * g.count]
    before = fa_ops.plain_calls
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 32) and gen.dtype == np.int32
    assert 0 <= gen.min() and gen.max() < cfg.vocab_size
    assert fa_ops.plain_calls - before == (
        kinds.count("attn") + kinds.count("attn_x") + cfg.encoder_layers)
    assert not tkernels.kernels_enabled()

"""The port's Griffin / RecurrentGemma modules against the JAX package's.

Smoke recurrentgemma-9b (d_model 128, lru_width 128, 4 query heads over 1 KV
head of 32, window 32, layers 2 x (rglru, rglru, local) + (rglru, rglru)) in
f32; weights from ``repro.models.init_params`` carried across by
``params_from_jax``; inputs drawn with numpy.  Tolerance 1e-5 absolute and
relative: both sides compute in f32 and differ only in the order of their
sums (the log-depth scans too: the port's doubling passes against
``lax.associative_scan``'s tree).  The gemma forms are also checked in bf16,
where both sides round at the same places.
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
import repro.models.attention as jattn
import repro.models.common as jcommon
import repro.models.decode as jdec
import repro.models.griffin as jgriffin
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.kernels as tkernels
import repro_torch.models.attention as tattn
import repro_torch.models.common as tcommon
import repro_torch.models.decode as tdec
import repro_torch.models.griffin as tgriffin
import repro_torch.models.transformer as ttf
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "recurrentgemma-9b"


@pytest.fixture(scope="module")
def cfgs():
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH), dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH), dtype="float32")
    return jc, tc


@pytest.fixture(scope="module")
def params(cfgs):
    jp = jax.jit(jtf.init_params, static_argnums=0)(cfgs[0], jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def rec0(params):
    """Layer 0's recurrent-block parameters on both sides."""
    jp, tp = params
    jl = jax.tree.map(lambda a: a[0], jp["groups"][0][0])
    return jl["rec"], ttf.layer_params(tp["groups"][0], 0)[0]["rec"]


@pytest.fixture(scope="module")
def local0(params):
    """The first LOCAL layer's attention parameters on both sides."""
    jp, tp = params
    jl = jax.tree.map(lambda a: a[0], jp["groups"][0][2])
    return jl["attn"], ttf.layer_params(tp["groups"][0], 0)[2]["attn"]


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


def _draw(*shape, seed=0, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


# -- configuration and parameters ------------------------------------------------

def test_config_copy_matches_reference(cfgs):
    jc, tc = cfgs
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tcfgs.get_config(ARCH)) == dataclasses.asdict(jcfgs.get_config(ARCH))
    full = tcfgs.get_config(ARCH)
    kinds = [k for g in full.groups for k in g.pattern * g.count]
    assert (kinds.count("rglru"), kinds.count("local"), full.n_layers) == (26, 12, 38)
    assert (tc.n_layers, tc.window, tc.lru_width, tc.n_kv_heads) == (8, 32, 128, 1)
    ttf.check_supported(full)
    assert tcommon.gemma_forms(tc) and not tcommon.gemma_forms(tcfgs.get_config("llama3.2-1b"))


def test_param_tree_matches_reference(cfgs, params):
    """The port's own init: same keys, shapes and dtypes, the same constants
    (norm scales 0 in the gemma form, conv bias 0, Lambda from 2 to 6) and
    dense leaves within 10% of the reference's std."""
    jc, tc = cfgs
    jp, _ = params
    own = ttf.init_params(tc, torch.Generator().manual_seed(0))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape) and str(a.dtype) == str(t.dtype).split(".")[1]
        a = np.asarray(a)
        if (a == a.flat[0]).all():
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.1
    assert float(own["final_norm"]["scale"].abs().max()) == 0.0
    for g in range(2):
        _close(own["groups"][g][0]["rec"]["lam"], jp["groups"][g][0]["rec"]["lam"], atol=1e-6)


def test_params_from_jax_mixed_dtypes_bit_exact():
    """bf16 config: matrices, conv and norms bf16; gates and Lambda f32; every
    leaf keeps its dtype and its bits through ``params_from_jax``."""
    jc = jcfgs.smoke_config(ARCH)
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree)
    rec = tp["groups"][0][0]["rec"]
    assert {k for k, v in rec.items() if v.dtype == torch.float32} == {"gate_a", "gate_x", "lam"}
    a_leaves, a_def = jax.tree.flatten(np_tree)
    b_leaves, b_def = jax.tree.flatten(tp)
    assert a_def == b_def
    for a, t in zip(a_leaves, b_leaves):
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            back = t.float().numpy().astype(ml_dtypes.bfloat16)
            np.testing.assert_array_equal(a.view(np.uint16), back.view(np.uint16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(a.view(np.uint32), t.numpy().view(np.uint32))


# -- the gemma forms ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_norm_and_embedding(dtype):
    """(1 + scale) RMSNorm and the sqrt(d_model) embedding scale, cast to the
    embedding's dtype before the product (in bf16, sqrt(128) is 11.3125)."""
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH), dtype=dtype)
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH), dtype=dtype)
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, size=(2, 9), dtype=np.int32)
    jx = jtf._embed_tokens(jc, jp, jnp.asarray(toks))
    tx = ttf._embed_tokens(tc, tp, torch.from_numpy(toks))
    assert str(tx.dtype).split(".")[1] == str(jx.dtype)
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx, np.float32))
    scale = np.random.default_rng(4).standard_normal(128, dtype=np.float32) * 0.1
    js = {"scale": jnp.asarray(scale).astype(jx.dtype)}
    ts = params_from_jax({"scale": np.asarray(js["scale"])})
    want = np.asarray(jcommon.apply_norm(jc, jx, js), np.float32)
    got = tcommon.apply_norm(tc, tx, ts)
    if dtype == "float32":
        _close(got, want)
    else:  # both compute in f32 and round once to bf16: within one rounding
        _close(got, want, atol=0, rtol=2 ** -7)
    not_plus_one = np.asarray(jcommon.rmsnorm(jx, js["scale"]), np.float32)
    assert np.abs(got.float().numpy() - not_plus_one).max() > 0.1


# -- the RG-LRU block ----------------------------------------------------------------

def test_block_linear_and_gates(rec0):
    jl, tl = rec0
    ju, tu = _draw(2, 7, 128, seed=5)
    _close(tgriffin._block_linear(tl["gate_a"], tu), jgriffin._block_linear(jl["gate_a"], ju))
    ja, jg = jgriffin._gates(jl, ju)
    ta, tg = tgriffin._gates(tl, tu)
    assert ta.dtype == tg.dtype == torch.float32
    _close(ta, ja)
    _close(tg, jg)
    assert float(ta.min()) < 1e-2  # the draw reaches strong decays


@pytest.mark.parametrize("S", [1, 37, 64])
def test_doubling_scan_vs_associative_scan(rec0, S):
    """Kernels off: the port's log-depth doubling passes against JAX's
    ``lax.associative_scan`` (``_scan_dispatch`` with Pallas off), at a
    length that is no power of two too."""
    jl, tl = rec0
    ju, tu = _draw(2, S, 128, seed=S)
    ja, jg = jgriffin._gates(jl, ju)
    ta, tg = tgriffin._gates(tl, tu)
    _close(tgriffin._scan_dispatch(ta, tg), jgriffin._scan_dispatch(ja, jg))


@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
def test_rglru_scan(rec0, kernels_on):
    """Kernels on: the port's kernel entry point (on the CPU, the sequential
    recurrence) against the Pallas kernel in interpret mode."""
    jl, tl = rec0
    ju, tu = _draw(2, 40, 128, seed=6)
    before = lru_ops.plain_calls
    got = tgriffin.rglru_scan(tl, tu)
    assert lru_ops.plain_calls - before == (1 if kernels_on else 0)
    _close(got, jgriffin.rglru_scan(jl, ju))


def test_rglru_step(rec0):
    jl, tl = rec0
    ju, tu = _draw(3, 128, seed=7)
    jh, th = _draw(3, 128, seed=8)
    jo, jstate = jgriffin.rglru_step(jl, ju, jh)
    to, tstate = tgriffin.rglru_step(tl, tu, th)
    _close(to, jo)
    _close(tstate, jstate)


@pytest.mark.parametrize("S", [2, 3, 16])
def test_causal_conv(rec0, S):
    """S = 2 and 3 leave the conv's history partly cold (S < width - 1 = 3
    and S = width - 1)."""
    jl, tl = rec0
    ju, tu = _draw(2, S, 128, seed=9)
    _close(tgriffin.causal_conv(tl, tu), jgriffin.causal_conv(jl, ju))


def test_causal_conv_step(rec0):
    jl, tl = rec0
    ju, tu = _draw(2, 128, seed=10)
    js, ts = _draw(2, 3, 128, seed=11)
    jo, jstate = jgriffin.causal_conv_step(jl, ju, js)
    to, tstate = tgriffin.causal_conv_step(tl, tu, ts)
    _close(to, jo)
    _close(tstate, jstate)


@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
def test_rglru_block(cfgs, rec0, kernels_on):
    jc, tc = cfgs
    jl, tl = rec0
    jx, tx = _draw(2, 24, 128, seed=12)
    _close(tgriffin.rglru_block(tc, tl, tx), jgriffin.rglru_block(jc, jl, jx))


@pytest.mark.parametrize("S", [2, 40])
@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
def test_rglru_block_prefill(cfgs, rec0, S, kernels_on):
    """The cache: h's last row in f32 and the conv tail, zero-padded in front
    when S < width - 1.  The port takes h from ``_scan_dispatch`` (the
    kernel's entry point with kernels on); JAX from ``associative_scan``."""
    jc, tc = cfgs
    jl, tl = rec0
    jx, tx = _draw(2, S, 128, seed=13 + S)
    before = lru_ops.plain_calls
    jy, jcache = jgriffin.rglru_block_prefill(jc, jl, jx)
    ty, tcache = tgriffin.rglru_block_prefill(tc, tl, tx)
    assert lru_ops.plain_calls - before == (1 if kernels_on else 0)
    _close(ty, jy)
    assert tcache["h"].dtype == torch.float32 and tuple(tcache["conv"].shape) == (2, 3, 128)
    for key in ("h", "conv"):
        _close(tcache[key], jcache[key])
    if S < 3:
        assert float(tcache["conv"][:, : 3 - S].abs().max()) == 0.0


def test_init_rglru_cache(cfgs):
    jc, tc = cfgs
    jcache = jgriffin.init_rglru_cache(jc, 3)
    tcache = tgriffin.init_rglru_cache(tc, 3)
    for key in ("h", "conv"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        assert str(tcache[key].dtype).split(".")[1] == str(jcache[key].dtype)
        _close(tcache[key], jcache[key])


def test_rglru_block_decode_updates_cache_in_place(cfgs, rec0):
    """Three steps from a drawn (non-zero) cache; the port writes h and the
    conv state into the cache it was given."""
    jc, tc = cfgs
    jl, tl = rec0
    jh, th = _draw(2, 128, seed=20)
    jconv, tconv = _draw(2, 3, 128, seed=21)
    jcache = {"h": jh, "conv": jconv}
    tcache = {"h": th.clone(), "conv": tconv.clone()}
    buffers = dict(tcache)
    for step in range(3):
        jx, tx = _draw(2, 1, 128, seed=22 + step)
        jy, jcache = jgriffin.rglru_block_decode(jc, jl, jx, jcache)
        ty, tcache = tgriffin.rglru_block_decode(tc, tl, tx, tcache)
        _close(ty, jy)
    for key in ("h", "conv"):
        assert tcache[key] is buffers[key]
        _close(tcache[key], jcache[key])


# -- sliding-window attention ----------------------------------------------------------

@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
def test_local_attend_binding_window(cfgs, kernels_on):
    """S = 40 over a window of 8: the window binds on most rows.  Kernels on:
    the flash kernel's entry point (its plain version here) against the
    Pallas flash kernel in interpret mode."""
    jc, tc = cfgs
    jq, tq = _draw(2, 40, 4, 32, seed=30)
    jk, tk = _draw(2, 40, 1, 32, seed=31)
    jv, tv = _draw(2, 40, 1, 32, seed=32)
    pos = np.arange(40, dtype=np.int32)
    before = fa_ops.plain_calls
    got = tattn.attend(tc, tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos), window=8)
    assert fa_ops.plain_calls - before == (1 if kernels_on else 0)
    want = jattn.attend(jc, jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), window=8)
    _close(got, want)


def test_cache_from_kv_ring_layout():
    """Capacity 32 < S = 40: the last 32 positions, slot = pos % 32."""
    jk, tk = _draw(2, 40, 1, 32, seed=33)
    jv, tv = _draw(2, 40, 1, 32, seed=34)
    pos = np.arange(40, dtype=np.int32)
    jcache = jattn.cache_from_kv(jk, jv, jnp.asarray(pos), 32)
    tcache = tattn.cache_from_kv(tk, tv, torch.from_numpy(pos), 32)
    for key in ("k", "v", "pos"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], atol=0, rtol=0)
    assert tcache["pos"].tolist() == [32 + i if i < 8 else i for i in range(32)]


def test_decode_attention_across_a_wrapped_ring(cfgs, local0):
    """Prefill 40 positions into a ring of 32 (window 32), then decode
    positions 40 .. 44, each overwriting the oldest slot."""
    jc, tc = cfgs
    jl, tl = local0
    jx, tx = _draw(2, 40, 128, seed=35)
    pos = np.arange(40, dtype=np.int32)
    _, jk, jv = jattn.qkv_proj(jc, jl, jx, jnp.asarray(pos))
    _, tk, tv = tattn.qkv_proj(tc, tl, tx, torch.from_numpy(pos))
    jcache = jattn.cache_from_kv(jk, jv, jnp.asarray(pos), 32)
    tcache = tattn.cache_from_kv(tk, tv, torch.from_numpy(pos), 32)
    jstep = jax.jit(functools.partial(jattn.decode_attention, jc, window=32))
    for p in range(40, 45):
        jy, ty = _draw(2, 1, 128, seed=p)
        jout, jcache = jstep(jl, jy, jnp.int32(p), jcache)
        tout, tcache = tattn.decode_attention(tc, tl, ty, p, tcache, window=32)
        _close(tout, jout)
    for key in ("k", "v", "pos"):
        _close(tcache[key], jcache[key])
    assert sorted(tcache["pos"].tolist()) == list(range(13, 45))


# -- the model ------------------------------------------------------------------------

@pytest.mark.parametrize("kind,index", [("rglru", 1), ("local", 2)])
def test_apply_layer_full(cfgs, params, kind, index):
    jc, tc = cfgs
    jp, tp = params
    jlayer = jax.tree.map(lambda a: a[1], jp["groups"][0][index])
    tlayer = ttf.layer_params(tp["groups"][0], 1)[index]
    jx, tx = _draw(2, 40, 128, seed=40)
    pos = np.arange(40, dtype=np.int32)
    jout, _ = jax.jit(jtf._apply_layer_full, static_argnums=(0, 1))(
        jc, kind, jlayer, jx, jnp.asarray(pos), None, None)
    _close(ttf._apply_layer_full(tc, kind, tlayer, tx, torch.from_numpy(pos)), jout)


@pytest.mark.parametrize("kernels_on", [False, True], indirect=True)
def test_forward_logits(cfgs, params, kernels_on):
    """Kernels on: the port's flash and RG-LRU entry points (their plain
    versions here) against JAX's Pallas kernels in interpret mode."""
    jc, tc = cfgs
    jp, tp = params
    toks = np.random.default_rng(41).integers(2, jc.vocab_size, size=(2, 40), dtype=np.int32)
    before = (fa_ops.plain_calls, lru_ops.plain_calls)
    jlog, _ = jax.jit(functools.partial(jtf.forward, jc))(jp, jnp.asarray(toks))
    tlog, aux = ttf.forward(tc, tp, torch.from_numpy(toks))
    calls = (fa_ops.plain_calls - before[0], lru_ops.plain_calls - before[1])
    assert calls == ((2, 6) if kernels_on else (0, 0))
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    _close(tlog, jlog)


def test_init_caches_match_reference(cfgs):
    """LOCAL caches hold min(window, capacity) slots; RGLRU caches h (f32)
    and the conv tail."""
    jc, tc = cfgs
    for capacity in (20, 48):
        jcache = jdec.init_caches(jc, 3, capacity)
        tcache = tdec.init_caches(tc, 3, capacity)
        jl, jdef = jax.tree.flatten(jcache)
        tl, tdef = jax.tree.flatten(tcache)
        assert jdef == tdef
        for j, t in zip(jl, tl):
            assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[1] == str(j.dtype)
            _close(t, j)
        assert tcache[0][2]["k"].shape[2] == min(32, capacity)

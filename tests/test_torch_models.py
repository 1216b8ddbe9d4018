"""The port's model modules against the JAX package's, on JAX's own weights.

Smoke llama3.2-1b in f32; weights from ``repro.models.init_params`` carried
across by ``params_from_jax``; inputs drawn with numpy.  Tolerance 1e-5
absolute and relative: both sides compute in f32 and differ only in the
order of their sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.attention as jattn
import repro.models.common as jcommon
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.models.attention as tattn
import repro_torch.models.common as tcommon
import repro_torch.models.transformer as ttf
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "llama3.2-1b"


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
def layer0(params):
    jp, tp = params
    return jax.tree.map(lambda a: a[0], jp["groups"][0][0]), ttf.layer_params(tp["groups"][0], 0)[0]


def _draw(*shape, seed=0, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_config_copy_matches_reference(cfgs):
    jc, tc = cfgs
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tcfgs.get_config(ARCH)) == dataclasses.asdict(jcfgs.get_config(ARCH))
    assert (tc.n_layers, tc.head_dim_, tc.vocab_padded) == (jc.n_layers, jc.head_dim_, jc.vocab_padded)


def test_param_tree_matches_reference(cfgs, params):
    """The port's own init: same keys, shapes, dtypes and std as JAX's."""
    jc, tc = cfgs
    jp, _ = params
    own = ttf.init_params(tc, torch.Generator().manual_seed(0))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape) and str(a.dtype) == str(t.dtype).split(".")[1]
        if float(jnp.std(a)) == 0.0:  # norm scales: constant
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        else:  # dense_init leaves: std within 10% of the reference's
            assert abs(float(t.std()) / float(jnp.std(a)) - 1) < 0.1


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(cfgs, layer0, plus_one):
    jl, tl = layer0
    jx, tx = _draw(2, 5, 128)
    js, ts = _draw(128, seed=1, scale=0.1)
    _close(tcommon.rmsnorm(tx, ts, plus_one=plus_one), jcommon.rmsnorm(jx, js, plus_one=plus_one))
    _close(tcommon.apply_norm(cfgs[1], tx, tl["ln1"]),
           jcommon.rmsnorm(jx, jl["ln1"]["scale"]))


def test_apply_rope(cfgs):
    jx, tx = _draw(2, 7, 4, 32)
    pos = np.arange(7, dtype=np.int32) + 1000
    theta = cfgs[0].rope_theta
    _close(tcommon.apply_rope(tx, torch.from_numpy(pos)[None], theta),
           jcommon.apply_rope(jx, jnp.asarray(pos)[None], theta))


def test_mlp_apply(cfgs, layer0):
    jl, tl = layer0
    jx, tx = _draw(2, 5, 128)
    _close(tcommon.mlp_apply(cfgs[1], tl["mlp"], tx), jcommon.mlp_apply(cfgs[0], jl["mlp"], jx))


def test_self_attention(cfgs, layer0):
    jl, tl = layer0
    jx, tx = _draw(2, 16, 128)
    pos = np.arange(16, dtype=np.int32)
    _close(tattn.self_attention(cfgs[1], tl["attn"], tx, torch.from_numpy(pos)),
           jax.jit(jattn.self_attention, static_argnums=0)(cfgs[0], jl["attn"], jx, jnp.asarray(pos)))


@pytest.mark.parametrize("Sq,Sk,window", [
    (24, 24, 0),  # dense path
    (24, 24, 8),  # dense path, sliding window
    (16, 2176, 0),  # chunked path: 2176 > 2048 keys, not a multiple of 512
])
def test_attend(cfgs, Sq, Sk, window):
    jc, tc = cfgs
    jq, tq = _draw(1, Sq, 4, 32, seed=1)
    jk, tk = _draw(1, Sk, 2, 32, seed=2)
    jv, tv = _draw(1, Sk, 2, 32, seed=3)
    qp = np.arange(Sk - Sq, Sk, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    got = tattn.attend(tc, tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp), window=window)
    want = jax.jit(jattn.attend, static_argnums=0, static_argnames="window")(
        jc, jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp), window=window)
    assert tuple(got.shape) == (1, Sq, 4, 32)
    _close(got, want)


def test_decode_attention_partly_filled_cache(cfgs, layer0):
    """Prefill 10 positions of a 24-slot cache, then decode position 10."""
    jc, tc = cfgs
    jl, tl = layer0
    jx, tx = _draw(2, 10, 128, seed=4)
    pos = np.arange(10, dtype=np.int32)
    _, jk, jv = jax.jit(jattn.qkv_proj, static_argnums=0)(jc, jl["attn"], jx, jnp.asarray(pos))
    _, tk, tv = tattn.qkv_proj(tc, tl["attn"], tx, torch.from_numpy(pos))
    jcache = jax.jit(jattn.cache_from_kv, static_argnums=3)(jk, jv, jnp.asarray(pos), 24)
    tcache = tattn.cache_from_kv(tk, tv, torch.from_numpy(pos), 24)
    jy, ty = _draw(2, 1, 128, seed=5)
    jout, jcache = jax.jit(jattn.decode_attention, static_argnums=0)(
        jc, jl["attn"], jy, jnp.int32(10), jcache)
    tout, tcache = tattn.decode_attention(tc, tl["attn"], ty, 10, tcache)
    _close(tout, jout)
    for key in ("k", "v", "pos"):
        _close(tcache[key], jcache[key])
    assert int(tcache["pos"][10]) == 10 and int(tcache["pos"][11]) == -1


def test_forward_logits(cfgs, params):
    jc, tc = cfgs
    jp, tp = params
    toks = np.random.default_rng(6).integers(2, jc.vocab_size, size=(2, 12), dtype=np.int32)
    jlog, _ = jax.jit(jtf.forward, static_argnums=0)(jc, jp, jnp.asarray(toks))
    tlog, aux = ttf.forward(tc, tp, torch.from_numpy(toks))
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    _close(tlog, jlog)


def test_init_caches_match_reference(cfgs):
    import repro.models.decode as jdec
    import repro_torch.models.decode as tdec

    jc, tc = cfgs
    jcache = jdec.init_caches(jc, 3, 20)
    tcache = tdec.init_caches(tc, 3, 20)
    jl, jdef = jax.tree.flatten(jcache)
    tl, tdef = jax.tree.flatten(tcache)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    tcache[0][0]["k"][1, 0, 5] = 1.0  # the stack holds one buffer per layer
    assert float(tcache[0][0]["k"][0].abs().sum()) == 0.0

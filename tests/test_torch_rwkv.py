"""The port's RWKV6 modules against the JAX package's, on JAX's own weights.

Smoke rwkv6-1.6b (d_model 128, head size 64 so H=2, d_ff 256, 2 layers) in
f32; weights from ``repro.models.init_params`` carried across by
``params_from_jax``; inputs drawn with numpy.  Tolerance 1e-5 absolute and
relative: both sides compute in f32 and differ only in the order of their
sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.decode as jdec
import repro.models.rwkv as jrwkv
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.models.decode as tdec
import repro_torch.models.rwkv as trwkv
import repro_torch.models.transformer as ttf
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "rwkv6-1.6b"


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
    """Layer 0's time-mix / channel-mix parameters on both sides."""
    jp, tp = params
    jl = jax.tree.map(lambda a: a[0], jp["groups"][0][0])
    return jl["tm_cm"], ttf.layer_params(tp["groups"][0], 0)[0]["tm_cm"]


def _draw(*shape, seed=0, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_config_copy_matches_reference(cfgs):
    jc, tc = cfgs
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tcfgs.get_config(ARCH)) == dataclasses.asdict(jcfgs.get_config(ARCH))
    assert (tc.d_model // tc.rwkv_head_dim, tc.n_layers) == (2, 2)


def test_param_tree_matches_reference(cfgs, params):
    """The port's own init: same keys, shapes and dtypes (f32 mixes, decay,
    bonus and norm scale; f32 matrices here, as the config is f32), and the
    same constants and std as JAX's."""
    jc, tc = cfgs
    jp, _ = params
    own = ttf.init_params(tc, torch.Generator().manual_seed(0))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape) and str(a.dtype) == str(t.dtype).split(".")[1]
        a = np.asarray(a)
        if (a == a.flat[0]).all():  # mixes, w0, u, norm scales: constants
            np.testing.assert_array_equal(t.numpy(), a)
        else:  # dense_init leaves: std within 10% of the reference's
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.1


def test_params_from_jax_mixed_dtypes_bit_exact():
    """bf16 config: matrices bf16, mixes/decay/bonus/norms f32; every leaf
    keeps its dtype and its bits."""
    jc = jcfgs.smoke_config(ARCH)
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree)
    a_leaves, a_def = jax.tree.flatten(np_tree)
    b_leaves, b_def = jax.tree.flatten(tp)
    assert a_def == b_def
    assert {str(a.dtype) for a in a_leaves} == {"bfloat16", "float32"}
    for a, t in zip(a_leaves, b_leaves):
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            back = t.float().numpy().astype(ml_dtypes.bfloat16)
            np.testing.assert_array_equal(a.view(np.uint16), back.view(np.uint16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(a.view(np.uint32), t.numpy().view(np.uint32))


@pytest.mark.parametrize("S,chunked", [(40, True), (40, False), (64, True)])
def test_time_mix_and_prefill(cfgs, layer0, S, chunked):
    jc, tc = cfgs
    jl, tl = layer0
    jx, tx = _draw(2, S, 128, seed=1)
    jf = jax.jit(jrwkv.rwkv_time_mix_prefill, static_argnums=0, static_argnames="chunked")
    jy, jstate = jf(jc, jl, jx, chunked=chunked)
    ty, tstate = trwkv.rwkv_time_mix_prefill(tc, tl, tx, chunked=chunked)
    _close(ty, jy)
    _close(tstate, jstate)
    _close(trwkv.rwkv_time_mix(tc, tl, tx, chunked=chunked),
           jax.jit(jrwkv.rwkv_time_mix, static_argnums=0, static_argnames="chunked")(
               jc, jl, jx, chunked=chunked))


def test_channel_mix(cfgs, layer0):
    jc, tc = cfgs
    jl, tl = layer0
    jx, tx = _draw(2, 12, 128, seed=2)
    _close(trwkv.rwkv_channel_mix(tc, tl, tx), jrwkv.rwkv_channel_mix(jc, jl, jx))


def test_group_norm_and_shift():
    jx, tx = _draw(2, 5, 2, 64, seed=3, scale=3.0)
    js, ts = _draw(2, 64, seed=4)
    _close(trwkv._group_norm(tx, ts), jrwkv._group_norm(jx, js))
    jp, tp = _draw(2, 2, 64, seed=5)
    _close(trwkv._shift(tx, tp), jrwkv._shift(jx, jp))
    _close(trwkv._shift(tx), jrwkv._shift(jx))


def test_decode_steps_update_cache_in_place(cfgs, layer0):
    """Both decode functions from a drawn (non-zero) cache; the port writes
    the new state and shifts into the cache it was given."""
    jc, tc = cfgs
    jl, tl = layer0
    js, ts = _draw(2, 2, 64, 64, seed=6, scale=0.3)
    jtm, ttm = _draw(2, 128, seed=7)
    jcm, tcm = _draw(2, 128, seed=8)
    jcache = {"state": js, "tm_shift": jtm, "cm_shift": jcm}
    tcache = {"state": ts.clone(), "tm_shift": ttm.clone(), "cm_shift": tcm.clone()}
    buffers = dict(tcache)
    jx, tx = _draw(2, 1, 128, seed=9)
    jy, jcache = jax.jit(jrwkv.rwkv_time_mix_decode, static_argnums=0)(jc, jl, jx, jcache)
    ty, tcache = trwkv.rwkv_time_mix_decode(tc, tl, tx, tcache)
    _close(ty, jy)
    jy2, jcache = jax.jit(jrwkv.rwkv_channel_mix_decode, static_argnums=0)(
        jc, jl, jx * 0.5, jcache)
    ty2, tcache = trwkv.rwkv_channel_mix_decode(tc, tl, tx * 0.5, tcache)
    _close(ty2, jy2)
    for key in ("state", "tm_shift", "cm_shift"):
        assert tcache[key] is buffers[key]
        _close(tcache[key], jcache[key])


def test_wkv_decode_step(cfgs):
    jr, tr = _draw(3, 2, 64, seed=10)
    jk, tk = _draw(3, 2, 64, seed=11)
    jv, tv = _draw(3, 2, 64, seed=12)
    jw, tw = _draw(3, 2, 64, seed=13)
    ju, tu = _draw(2, 64, seed=14, scale=0.1)
    js, ts = _draw(3, 2, 64, 64, seed=15)
    jy, jstate = jrwkv.wkv_decode_step(jr, jk, jv, -jnp.exp(jw), ju, js)
    ty, tstate = trwkv.wkv_decode_step(tr, tk, tv, -torch.exp(tw), tu, ts)
    _close(ty, jy)
    _close(tstate, jstate)


def test_apply_layer_full(cfgs, params):
    jc, tc = cfgs
    jp, tp = params
    jlayer = jax.tree.map(lambda a: a[1], jp["groups"][0][0])
    tlayer = ttf.layer_params(tp["groups"][0], 1)[0]
    jx, tx = _draw(2, 33, 128, seed=16)
    pos = np.arange(33, dtype=np.int32)
    jout, _ = jax.jit(jtf._apply_layer_full, static_argnums=(0, 1))(
        jc, "rwkv", jlayer, jx, jnp.asarray(pos), None, None)
    _close(ttf._apply_layer_full(tc, "rwkv", tlayer, tx, torch.from_numpy(pos)), jout)


def test_forward_logits(cfgs, params):
    jc, tc = cfgs
    jp, tp = params
    toks = np.random.default_rng(17).integers(2, jc.vocab_size, size=(2, 20), dtype=np.int32)
    jlog, _ = jax.jit(jtf.forward, static_argnums=0)(jc, jp, jnp.asarray(toks))
    tlog, aux = ttf.forward(tc, tp, torch.from_numpy(toks))
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    _close(tlog, jlog)


def test_init_caches_match_reference(cfgs):
    jc, tc = cfgs
    jcache = jdec.init_caches(jc, 3, 20)
    tcache = tdec.init_caches(tc, 3, 20)
    jl, jdef = jax.tree.flatten(jcache)
    tl, tdef = jax.tree.flatten(tcache)
    assert jdef == tdef
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[1] == str(j.dtype)
        _close(t, j)
    tcache[0][0]["state"][1, 0, 0, 5] = 1.0  # the stack holds one buffer per layer
    assert float(tcache[0][0]["state"][0].abs().sum()) == 0.0


def test_check_supported_names_ported_kinds():
    """Any mix of the ported kinds runs (RWKV with ATTN, all RGLRU, RWKV with
    XATTN or ATTNX, MoE); a kind the port does not know is refused, the
    refusal naming the ported kinds.  Experts go only to ATTN and LOCAL
    layers: an RWKV layer of a config with experts keeps its channel-mix."""
    cfg = tcfgs.get_config(ARCH)
    ttf.check_supported(cfg)
    ported = dataclasses.replace(cfg, groups=(tcfgs.LayerGroup(pattern=("rwkv", "attn"), count=2),))
    ttf.check_supported(ported)
    ttf.check_supported(dataclasses.replace(cfg, groups=(tcfgs.LayerGroup(("rglru",), 1),)))
    for kind in ("xattn", "attn_x"):
        ttf.check_supported(dataclasses.replace(
            cfg, groups=(tcfgs.LayerGroup(pattern=("rwkv", kind), count=2),)))
    mixed = dataclasses.replace(cfg, groups=(tcfgs.LayerGroup(pattern=("rwkv", "ssm"), count=2),))
    with pytest.raises(NotImplementedError,
                       match=r"\('attn', 'local', 'xattn', 'attn_x', 'rwkv', 'rglru'\)"):
        ttf.check_supported(mixed)
    ttf.check_supported(dataclasses.replace(tcfgs.get_config("llama3.2-1b"), n_experts=4, top_k=2))
    small = dataclasses.replace(tcfgs.smoke_config(ARCH), n_experts=4, top_k=2)
    layer = ttf.init_params(small, torch.Generator())["groups"][0][0]
    assert "tm_cm" in layer and "moe" not in layer
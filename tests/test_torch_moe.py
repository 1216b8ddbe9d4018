"""The MoE layer and the two MoE models, mixtral-8x22b and dbrx-132b, against
the JAX package, on JAX's own weights.

Smoke widths (d 128, d_ff 256), weights from the reference's
``init_params`` carried across by ``params_from_jax``, inputs drawn with
numpy.  The layer is held at the smoke configs' routing (4 experts, top-2)
and at the published archs' (mixtral 8 experts, top-2; dbrx 16, top-4),
the same ``dataclasses.replace`` applied to both packages' configs.  In f32
the router's gates and aux loss agree to 1e-6 and pick the same experts
(each case reports the smallest margin between a token's k-th and
(k+1)-th router probability at its seed, and asserts it is far above f32's
noise: at seed 0 the margins are 1.65e-3, 2.4e-3 and 4.09e-5 for 4, 8 and
16 experts, the packages' probabilities differ by at most 2.4e-7), and the layer's output to 1e-4 (the expert products
sum in another order) for one and for two FF shards an expert (the
reference's ``init_params(ep_shards=)`` layout); in bf16 the layer's output
to 1e-2, above a rounding of its bf16 outputs (about 4e-3 at their size).
``forward`` holds the logits and the summed aux loss to 1e-4 with kernels
off and on (JAX's Pallas flash kernel in interpret mode, the port's plain
version on the CPU), at a sequence of 40 that wraps mixtral's smoke window
of 32.  Prefill and decode are held in ``test_torch_serve.py``.
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
import repro.models.moe as jmoe
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.kernels as tkernels
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttf
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ARCHS = ["mixtral-8x22b", "dbrx-132b"]
# (n_experts, top_k): the smoke configs' cut, mixtral's and dbrx's published
ROUTINGS = [(4, 2), (8, 2), (16, 4)]
B, S = 2, 16


def _cfgs(arch, dtype="float32", routing=(4, 2)):
    E, k = routing
    return tuple(dataclasses.replace(pkg.smoke_config(arch), dtype=dtype, n_experts=E, top_k=k)
                 for pkg in (jcfgs, tcfgs))


@functools.lru_cache(maxsize=None)
def _jax_params(jc, ep_shards=1):
    init = jax.jit(jtf.init_params, static_argnums=(0, 2))
    return jax.tree.map(np.asarray, init(jc, jax.random.PRNGKey(0), ep_shards))


def _layer0_moe(jc, ep_shards=1):
    """Layer 0's MoE weights in the reference's ``init_params(ep_shards=)``
    layout: (numpy tree, port tree)."""
    jl = jax.tree.map(lambda a: a[0], _jax_params(jc, ep_shards)["groups"][0][0]["moe"])
    return jl, params_from_jax(jl)


def _x(dtype=np.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, S, 128), dtype=np.float32)
    return x.astype(dtype)


def test_configs_match_reference():
    assert len(tcfgs.ARCHS) == len(jcfgs.ARCHS) == 10
    for arch in ARCHS:
        assert dataclasses.asdict(tcfgs.get_config(arch)) == dataclasses.asdict(
            jcfgs.get_config(arch))
        smoke = tcfgs.smoke_config(arch)
        assert dataclasses.asdict(smoke) == dataclasses.asdict(jcfgs.smoke_config(arch))
        assert (smoke.n_experts, smoke.top_k) == (4, 2)
        ttf.check_supported(tcfgs.get_config(arch))
    assert tcfgs.smoke_config("mixtral-8x22b").window == 32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_route_matches_reference(arch, routing):
    jc, tc = _cfgs(arch, routing=routing)
    jl, tl = _layer0_moe(jc)
    x = _x().reshape(-1, 128)
    jg, jidx, jaux = jmoe._route(jc, jnp.asarray(jl["router"]), jnp.asarray(x))
    tg, tidx, taux = tmoe._route(tc, tl["router"], torch.from_numpy(x))
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jl["router"], axis=-1))
    tprobs = torch.softmax(torch.from_numpy(x) @ tl["router"], dim=-1).numpy()
    noise = float(np.max(np.abs(tprobs - jprobs)))  # the packages' f32 disagreement
    probs = np.sort(jprobs, -1)
    margin = float(np.min(probs[:, -tc.top_k] - probs[:, -tc.top_k - 1]))
    report = f"smallest top-k margin {margin:.3g}, router probabilities differ by {noise:.3g}"
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx), err_msg=report)
    assert tg.dtype == torch.float32 and tidx.shape == (B * S, tc.top_k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    # no route this close to a tie that f32 noise could flip it: the margin
    # clears 100x the measured disagreement, and 4e-4 of the mean
    # probability 1/E (1e-4 at the smoke configs' 4 experts)
    assert margin > 100 * noise and margin > 4e-4 / tc.n_experts, report


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("ep_shards", [1, 2])
def test_moe_apply_dense_matches_reference(arch, routing, ep_shards):
    jc, tc = _cfgs(arch, routing=routing)
    jl, tl = _layer0_moe(jc, ep_shards)
    assert tl["w_in"].shape == (routing[0] * ep_shards, 128, 2 * 256 // ep_shards)
    x = _x()
    jy, jaux = jmoe.moe_apply_dense(jc, jl, jnp.asarray(x))
    ty, taux = tmoe.moe_apply_dense(tc, tl, torch.from_numpy(x))
    assert ty.shape == (B, S, 128) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)


def test_moe_apply_dense_bf16_matches_reference():
    jc, tc = _cfgs("mixtral-8x22b", "bfloat16")
    jl, tl = _layer0_moe(jc)
    x = _x(ml_dtypes.bfloat16)
    jy, jaux = jmoe.moe_apply_dense(jc, jl, jnp.asarray(x))
    ty, taux = tmoe.moe_apply_dense(tc, tl, torch.from_numpy(x.astype(np.float32)).bfloat16())
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_match_reference(arch):
    """The port's own init: the reference's keys, shapes and dtypes (the
    router f32 in a bf16 model), stacked over the layer count, and each
    leaf's std within 10% of the reference's."""
    jc, tc = _cfgs(arch, "bfloat16")
    jp = _jax_params(jc)
    own = ttf.init_params(tc, torch.Generator().manual_seed(0))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape) and str(a.dtype) == str(t.dtype).split(".")[1]
    jm, tm = jp["groups"][0][0]["moe"], own["groups"][0][0]["moe"]
    assert set(tm) == {"router", "w_in", "w_out"} and "mlp" not in own["groups"][0][0]
    assert tm["router"].dtype == torch.float32 and tm["w_in"].dtype == torch.bfloat16
    for key in tm:
        assert abs(float(tm[key].float().std()) / float(np.std(jm[key].astype(np.float32)))
                   - 1) < 0.1, key


def test_params_from_jax_keeps_the_router_f32_in_a_bf16_tree():
    """The f32 router stays f32 and equal; the bf16 experts bit for bit."""
    jc, _ = _cfgs("dbrx-132b", "bfloat16")
    jp = _jax_params(jc)
    tp = params_from_jax(jp)
    for jm, tm in ((j[0]["moe"], t[0]["moe"]) for j, t in zip(jp["groups"], tp["groups"])):
        assert jm["router"].dtype == np.float32 and tm["router"].dtype == torch.float32
        np.testing.assert_array_equal(tm["router"].numpy(), jm["router"])
        for key in ("w_in", "w_out"):
            assert tm[key].dtype == torch.bfloat16
            back = tm[key].float().numpy().astype(ml_dtypes.bfloat16)
            np.testing.assert_array_equal(back.view(np.uint16), jm[key].view(np.uint16))
    assert {t.dtype for t in jax.tree.leaves(tp)} == {torch.bfloat16, torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernels_on", [False, True])
def test_forward_matches_reference(arch, kernels_on):
    """Logits and the aux loss (each MoE layer's, summed, times 0.01)."""
    jc, tc = _cfgs(arch)
    jp = _jax_params(jc)
    tokens = np.random.default_rng(0).integers(2, jc.vocab_size, size=(B, 40), dtype=np.int32)
    jkernels.use_pallas(kernels_on)
    tkernels.use_kernels(kernels_on)
    try:
        jlog, jaux = jax.jit(jtf.forward, static_argnums=0)(jc, jp, jnp.asarray(tokens))
        tlog, taux = ttf.forward(tc, params_from_jax(jp), torch.from_numpy(tokens))
    finally:
        jkernels.use_pallas(False)
        tkernels.use_kernels(False)
    assert float(taux) > 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-4)

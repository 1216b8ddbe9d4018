"""The three dense decoders added together, olmo-1b, codeqwen1.5-7b and
gemma2-9b, against the JAX package: their config copies, gemma2's parameter
tree with its post-norms (``post_ln1`` after attention, ``post_ln2`` after
the MLP), the full-sequence ``forward`` in f32 at 1e-4 on JAX's own weights
with kernels off and on (JAX's Pallas flash kernel in interpret mode, the
port's plain version on the CPU), and what ``check_supported`` takes and
refuses (since mixtral-8x22b and dbrx-132b, only a layer kind it does not
know).  Prefill
and decode are held in ``test_torch_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.kernels as jkernels
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.kernels as tkernels
import repro_torch.models.transformer as ttf
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

NEW = ["olmo-1b", "codeqwen1.5-7b", "gemma2-9b"]


@pytest.mark.parametrize("arch", NEW)
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(tcfgs.get_config(arch)) == dataclasses.asdict(jcfgs.get_config(arch))
    assert dataclasses.asdict(tcfgs.smoke_config(arch)) == dataclasses.asdict(
        jcfgs.smoke_config(arch))


def test_gemma2_param_tree_matches_reference():
    """The port's own init: the same keys (post_ln1 and post_ln2 in every
    layer), shapes and dtypes as JAX's; the gemma forms' norm scales start
    at 0 in both."""
    jc = jcfgs.smoke_config("gemma2-9b")
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    own = ttf.init_params(tcfgs.smoke_config("gemma2-9b"), torch.Generator().manual_seed(0))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for layer in own["groups"][0]:
        assert {"post_ln1", "post_ln2"} <= set(layer)
        assert float(layer["post_ln1"]["scale"].abs().sum()) == 0.0
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape) and str(a.dtype) == str(t.dtype).split(".")[1]


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("kernels_on", [False, True])
def test_forward_logits_match_reference(arch, kernels_on):
    """Sequence 40 wraps gemma2's smoke window of 32 in its LOCAL layers."""
    jc = dataclasses.replace(jcfgs.smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(arch), dtype="float32")
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(2, jc.vocab_size, size=(2, 40), dtype=np.int32)
    jkernels.use_pallas(kernels_on)
    tkernels.use_kernels(kernels_on)
    try:
        jlog, _ = jax.jit(jtf.forward, static_argnums=0)(jc, jp, jnp.asarray(toks))
        tlog, aux = ttf.forward(tc, tp, torch.from_numpy(toks))
    finally:
        jkernels.use_pallas(False)
        tkernels.use_kernels(False)
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,change", [
    ("gemma2-9b", {}),
    ("olmo-1b", {}),
    ("codeqwen1.5-7b", {}),
    ("llama3.2-1b", {"post_norms": True}),
])
def test_check_supported_takes_the_dense_decoders_and_post_norms(arch, change):
    ttf.check_supported(dataclasses.replace(tcfgs.get_config(arch), **change))


MOE = {"n_experts": 4, "top_k": 2}


@pytest.mark.parametrize("change", [
    MOE,
    {"encoder_layers": 2, **MOE},
    {"groups": (tcfgs.LayerGroup(pattern=("attn", "xattn"), count=2),), **MOE},
    {"groups": (tcfgs.LayerGroup(pattern=("attn_x",), count=2),), **MOE},
    {"groups": (tcfgs.LayerGroup(pattern=("attn", "ssm"), count=2),), **MOE},
])
def test_check_supported_refuses_moe_encoders_and_cross_attention(change):
    """Encoders and cross-attention layers (whisper-small,
    llama-3.2-vision-11b) and MoE (mixtral-8x22b, dbrx-132b) are ported:
    MoE is taken alone and beside the others, with and without experts.
    What is still refused is a layer kind the port does not know."""
    cfg = dataclasses.replace(tcfgs.get_config("gemma2-9b"), **change)
    for c in (cfg, dataclasses.replace(cfg, n_experts=0, top_k=0)):
        if "ssm" in c.groups[0].pattern:
            with pytest.raises(NotImplementedError, match="ssm"):
                ttf.check_supported(c)
        else:
            ttf.check_supported(c)

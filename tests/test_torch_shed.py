"""Shedding an in-flight sequence (``repro_torch.models.decode.cut_caches``
and ``DecodeGraph.shed``) at smoke width, all ten archs, on the CPU.

The JAX serve loop sheds by slicing every cache leaf, along each axis whose
size differs, to the shapes ``jax.eval_shape`` of prefill gives at B-1
(``src/repro/launch/serve.py``'s ``handle_host_drop``).  The port takes the
shapes from ``init_caches`` on the meta device.  On caches carried from the
reference's prefill, the two cuts must be equal leaf by leaf, and every cut
leaf must be a new contiguous tensor.  An f32 ``serve.run`` that sheds must
give the unshed run's rows 0..B-2 token for token, and the shed row -1 after
the step it was shed at.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.decode as jdec
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.models.decode as tdec
from _torch_obs_parity import _fresh_planners, fresh_both  # noqa: F401  (autouse)
from repro_torch.launch import serve as t_serve
from repro_torch.models.convert import params_from_jax, tree_leaves
from repro_torch.models.transformer import init_params as tinit_params

ARCHS = ["llama3.2-1b", "rwkv6-1.6b", "recurrentgemma-9b", "olmo-1b", "codeqwen1.5-7b",
         "gemma2-9b", "whisper-small", "llama-3.2-vision-11b", "mixtral-8x22b", "dbrx-132b"]
# prompts longer than the smoke window of 32 where the arch has LOCAL layers
PROMPT = {"recurrentgemma-9b": 40, "gemma2-9b": 40, "mixtral-8x22b": 40}
B, NEW = 3, 6


def _reference_cut(cfg, params, prompts, frontend, capacity):
    """The JAX serve loop's shed, on the reference's own prefill caches."""
    _, caches = jdec.prefill(cfg, params, prompts, frontend=frontend, capacity=capacity)
    new_b = prompts.shape[0] - 1
    target = jax.eval_shape(
        lambda p, t, f: jdec.prefill(cfg, p, t, frontend=f, capacity=capacity),
        params, jax.ShapeDtypeStruct((new_b, prompts.shape[1]), jnp.int32),
        None if frontend is None else jax.ShapeDtypeStruct(
            (new_b,) + frontend.shape[1:], frontend.dtype))[1]

    def _slice(live, tgt):
        out = live
        for ax in range(out.ndim):
            if out.shape[ax] != tgt.shape[ax]:
                out = jax.lax.slice_in_dim(out, 0, tgt.shape[ax], axis=ax)
        return out

    return caches, jax.tree_util.tree_map(_slice, caches, target)


@pytest.mark.parametrize("arch", ARCHS)
def test_cut_caches_equals_reference_cut(arch):
    jc = dataclasses.replace(jcfgs.smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(arch), dtype="float32")
    params = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    P = PROMPT.get(arch, 16)
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(2, jc.vocab_size, size=(B, P), dtype=np.int32))
    frontend = None
    if jc.frontend_tokens:
        frontend = jnp.asarray(rng.standard_normal(
            (B, jc.frontend_tokens, jc.frontend_dim or jc.d_model), dtype=np.float32))
    jcaches, jcut = _reference_cut(jc, params, prompts, frontend, P + NEW)
    tcaches = params_from_jax(jax.tree.map(np.asarray, jcaches))
    tcut = tdec.cut_caches(tc, tcaches, B - 1, P + NEW)
    want, got, live = jax.tree.leaves(jcut), tree_leaves(tcut), tree_leaves(tcaches)
    assert len(want) == len(got) == len(live) > 0
    n_cut = 0
    for w, g, src in zip(want, got, live):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == src.dtype
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.is_contiguous() and g.untyped_storage().data_ptr() != \
            src.untyped_storage().data_ptr()
        n_cut += tuple(g.shape) != tuple(src.shape)
    assert n_cut > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_shed_keeps_the_other_rows(arch, capsys):
    """f32 ``serve.run`` on the CPU: shed at step 2 of 6, rows 0..B-2 equal
    the unshed run's and the last row is the unshed row's up to step 2 and
    -1 after it; the caches the step goes on with are the cut ones."""
    cfg = dataclasses.replace(tcfgs.smoke_config(arch), dtype="float32")
    kw = dict(batch=B, prompt_len=PROMPT.get(arch, 16), new_tokens=NEW, seed=0, device="cpu")
    unshed = t_serve.run(cfg, **kw)
    fresh_both()
    shed = t_serve.run(cfg, **kw, fail_at=2, fail_mode="shed")
    out = capsys.readouterr().out
    assert "[serve] host 0 lost at decode step 2; shed one sequence (batch 3 -> 2)" in out
    np.testing.assert_array_equal(shed[:B - 1], unshed[:B - 1])
    np.testing.assert_array_equal(shed[B - 1, :3], unshed[B - 1, :3])
    assert (shed[B - 1, 3:] == -1).all()


def test_decode_graph_shed_twice_and_refusals():
    """Two sheds leave one row; a third is refused, as is a shed after the
    last step.  Each shed row keeps the token of the step it was shed at."""
    cfg = dataclasses.replace(tcfgs.smoke_config("llama3.2-1b"), dtype="float32")
    params = tinit_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(B, 8), dtype=np.int32))
    logits, caches = tdec.prefill(cfg, params, prompts, capacity=8 + NEW)
    steps = tdec.DecodeGraph(cfg, params, caches, logits.argmax(-1)[:, None], 8, NEW)
    steps.step()
    fed = steps.token[:, 0].clone()
    steps.shed(tdec.cut_caches(cfg, steps.caches, 2, 8 + NEW))
    steps.step()
    steps.shed(tdec.cut_caches(cfg, steps.caches, 1, 8 + NEW))
    assert steps.batch == 1
    with pytest.raises(ValueError, match="already 1"):
        steps.shed(steps.caches)
    while steps.steps < NEW:
        steps.step()
    assert steps.tokens[2, 1] == fed[2] and (steps.tokens[2, 2:] == -1).all()
    assert (steps.tokens[1, 3:] == -1).all() and (steps.tokens[0] >= 0).all()
    assert steps.recapture_seconds == [] and steps.graph is None  # nothing captured on the CPU
    with pytest.raises(RuntimeError, match="steps have run"):
        steps.shed(steps.caches)

"""The decode step with ``pos`` as a device tensor, as the JAX package traces
it, against the step with ``pos`` as an int, and ``DecodeGraph`` on the CPU.

Smoke widths of all ten archs the port serves, in f32, on JAX's own
weights (``params_from_jax``), prompts and whisper's and llama-vision's
frontend drawn with numpy, every XATTN gate set non-zero.  The two forms of ``pos``
run the same operations on the same values, so logits and every cache leaf
must be equal bit for bit (``torch.equal``), not close: recurrentgemma and
gemma2 at a prompt of 40, which wraps their smoke window of 32 (each LOCAL
cache is a ring that the tensor slot ``pos % 32`` must hit as the int one
did), rwkv6 with its WKV state and token shifts, whisper with its learned
position read at the tensor ``pos`` and its ATTNX caches (a nested ``kv``
beside the cross K/V), mixtral (a wrapped ring too) and dbrx through their
MoE layers.  On the CPU ``DecodeGraph``
runs its step eagerly; its generations and logits must equal the plain
greedy loop's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.transformer as jtf
import repro_torch.configs as tcfgs
import repro_torch.models.decode as tdec
from repro_torch.models.convert import draw_xattn_gates, params_from_jax

torch.set_num_threads(1)

ARCHS = ["llama3.2-1b", "rwkv6-1.6b", "recurrentgemma-9b", "olmo-1b", "codeqwen1.5-7b",
         "gemma2-9b", "whisper-small", "llama-3.2-vision-11b", "mixtral-8x22b", "dbrx-132b"]
# prompts longer than the smoke window of 32 where the arch has LOCAL layers
PROMPT = {"recurrentgemma-9b": 40, "gemma2-9b": 40, "mixtral-8x22b": 40}
B, STEPS = 2, 6


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _setup(arch):
    """Port config and params, prompts, and the frontend (None without one);
    XATTN gates set to ±[0.3, 1.0), since at zero the layer adds nothing."""
    jc = dataclasses.replace(jcfgs.smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(arch), dtype="float32")
    jp = jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    P = PROMPT.get(arch, 16)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, tc.vocab_size, size=(B, P), dtype=np.int32)
    jp = jax.tree.map(np.asarray, jp)
    draw_xattn_gates(jp, rng)
    tp = params_from_jax(jp)
    frontend = None
    if tc.frontend_tokens:
        frontend = torch.from_numpy(rng.standard_normal(
            (B, tc.frontend_tokens, tc.frontend_dim or tc.d_model), dtype=np.float32))
    return tc, tp, torch.from_numpy(prompts), frontend


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_pos_step_equals_int_pos_step(arch):
    tc, tp, prompts, frontend = _setup(arch)
    P = prompts.shape[1]
    logits, caches = {}, {}
    for form in ("int", "tensor"):
        lg, cache = tdec.prefill(tc, tp, prompts, frontend=frontend, capacity=P + STEPS)
        logs = [lg]
        for i in range(STEPS):
            tok = logs[-1].argmax(-1)[:, None]
            pos = P + i if form == "int" else torch.tensor(P + i, dtype=torch.int32)
            lg, cache = tdec.decode_step(tc, tp, cache, tok, pos)
            logs.append(lg)
        logits[form], caches[form] = logs, cache
    for a, b in zip(logits["int"], logits["tensor"]):
        assert torch.equal(a, b)
    leaves = [_leaves(caches[form]) for form in ("int", "tensor")]
    assert len(leaves[0]) == len(leaves[1])
    for a, b in zip(*leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # where the rings wrapped, each LOCAL cache holds the last 32 positions
    rings = [c["pos"][rep] for group, gc in zip(tc.groups, caches["tensor"])
             for kind, c in zip(group.pattern, gc) if kind == "local"
             for rep in range(group.count)]
    assert len(rings) == (2 if arch in PROMPT else 0)
    for ring in rings:
        assert sorted(ring.tolist()) == list(range(P + STEPS - 32, P + STEPS))


@pytest.mark.parametrize("arch", ["gemma2-9b", "rwkv6-1.6b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_decode_graph_on_cpu_equals_the_greedy_loop(arch):
    """``DecodeGraph`` stores the token each step is fed, writes its pick back
    into its token buffer and advances its own ``pos``: the same generations,
    logits and caches as feeding each pick back by hand with an int ``pos``."""
    tc, tp, prompts, frontend = _setup(arch)
    P = prompts.shape[1]
    lg, cache = tdec.prefill(tc, tp, prompts, frontend=frontend, capacity=P + STEPS)
    tok = lg.argmax(-1)[:, None]
    want_toks, want_logs = [], []
    for i in range(STEPS):
        want_toks.append(tok[:, 0])
        lg, cache = tdec.decode_step(tc, tp, cache, tok, P + i)
        want_logs.append(lg)
        tok = lg.argmax(-1)[:, None]

    lg, cache2 = tdec.prefill(tc, tp, prompts, frontend=frontend, capacity=P + STEPS)
    steps = tdec.DecodeGraph(tc, tp, cache2, lg.argmax(-1)[:, None], P, STEPS)
    for want in want_logs:
        assert torch.equal(steps.step(), want)
    assert steps.graph is None  # nothing is captured on the CPU
    assert torch.equal(steps.tokens, torch.stack(want_toks, dim=1))
    assert int(steps.pos) == P + STEPS and torch.equal(steps.token, tok)
    for a, b in zip(_leaves(cache), _leaves(cache2)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="steps have run"):
        steps.step()


def test_decode_graph_takes_a_tensor_pos():
    """A 0-d tensor ``pos`` gives the same generations as an int one, and the
    graph advances its own copy: the caller's tensor keeps its value."""
    tc, tp, prompts, _ = _setup("llama3.2-1b")
    P = prompts.shape[1]
    runs = {}
    for form in ("int", "tensor"):
        lg, cache = tdec.prefill(tc, tp, prompts, capacity=P + STEPS)
        pos = P if form == "int" else torch.tensor(P, dtype=torch.int32)
        steps = tdec.DecodeGraph(tc, tp, cache, lg.argmax(-1)[:, None], pos, STEPS)
        logs = [steps.step() for _ in range(STEPS)]
        runs[form] = (steps, logs, cache)
        if form == "tensor":
            assert int(pos) == P
    (s_int, l_int, c_int), (s_t, l_t, c_t) = runs["int"], runs["tensor"]
    assert torch.equal(s_int.tokens, s_t.tokens) and int(s_t.pos) == P + STEPS
    for a, b in zip(l_int, l_t):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(c_int), _leaves(c_t)):
        assert torch.equal(a, b)

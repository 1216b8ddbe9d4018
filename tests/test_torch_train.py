"""The port's training pieces against the JAX package's, on the CPU.

RunConfig, the schedule, AdamW leaf by leaf (f32 and bf16 parameters), the
synthetic batches bit for bit, ``train_step`` with microbatches in both
accumulation dtypes and in bf16, the remat policies' gradients, the
frontend dtype both packages refuse, and the kernel wrappers' refusal of
inputs that require grad.  Weights come from the JAX package's
``init_params`` through ``params_from_jax``; the ten-arch f32 parity is in
``test_torch_train_archs_{a,b}.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jcfgs
import repro.optim as jopt
import repro_torch.configs as tcfgs
import repro_torch.optim as topt
from _torch_train_parity import (
    abs_diff_sum,
    assert_trees_close,
    configs,
    rel_err,
    run_both,
    run_configs,
    start,
)
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_params as jinit_params
from repro.models.steps import train_step as jtrain_step
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import (
    opt_state_from_jax,
    params_from_jax,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.steps import next_token_loss, train_step as ttrain_step

torch.set_num_threads(1)


def test_run_config_copy_matches_reference():
    """The port keeps the reference's fields that ``train_step`` reads, with
    the reference's defaults."""
    jc, tc = jcfgs.smoke_config("llama3.2-1b"), tcfgs.smoke_config("llama3.2-1b")
    jr, tr = dataclasses.asdict(JRunConfig(model=jc)), dataclasses.asdict(TRunConfig(model=tc))
    assert set(tr) <= set(jr)
    assert tr == {k: jr[k] for k in tr}
    assert (tr["remat"], tr["remat_policy"], tr["grad_accum_dtype"]) == (True, "block", "float32")


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 4), (0, 5), (5, 5), (3, 2)])
def test_warmup_cosine_matches_reference(warmup, total):
    steps = np.arange(total + 3, dtype=np.int32)
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    want = np.array([float(jopt.warmup_cosine(jnp.int32(s), **kw)) for s in steps])
    got = np.array([float(topt.warmup_cosine(torch.tensor(s), **kw)) for s in steps])
    assert topt.warmup_cosine(torch.tensor(0, dtype=torch.int32), **kw).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if warmup:
        assert got[0] == 0.0  # the first step moves no weight


def _tree(rng, dtype) -> dict:
    """A parameter tree of the port's kinds: dicts, a stacked tuple, a None."""
    def leaf(*shape):
        return rng.standard_normal(shape, dtype=np.float32).astype(dtype)
    return {"embed": {"tok": leaf(16, 8)}, "final_norm": None,
            "groups": ({"ln1": {"scale": leaf(2, 8)}, "ln2": None, "w": leaf(2, 8, 4)},)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_leaf_by_leaf(dtype):
    """Three steps of norm, clip (the first two clip, the third does not),
    and update; f32 leaves at 1e-6 of each leaf's largest magnitude, bf16
    parameters to one bf16 rounding."""
    rng = np.random.default_rng(0)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    jp = jax.tree.map(jnp.asarray, _tree(rng, np_dt))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jo, to = jopt.init_state(jp), topt.init_state(tp)
    assert all(m.dtype == torch.float32 for m in tree_leaves(to.mu))
    cfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1)
    tcfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    for i, scale in enumerate((3.0, 1.0, 0.01)):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape, dtype=np.float32) * scale).astype(p.dtype), jp)
        tg = tree_leaves(params_from_jax(jax.tree.map(np.asarray, g)))
        jn, tn = jopt.global_norm(g), topt.global_norm(tg)
        assert rel_err(tn, jn) < 1e-6
        jg, jnorm = jopt.clip_by_global_norm(g, cfg.grad_clip)
        tg, tnorm = topt.clip_by_global_norm(tg, tcfg.grad_clip)
        assert rel_err(tnorm, jnorm) < 1e-6
        assert [t.dtype for t in tg] == [t.dtype for t in tree_leaves(tp)]
        for t, j in zip(tg, jax.tree.leaves(jg)):
            assert rel_err(t, np.asarray(j, np.float32)) <= (2**-8 if dtype == "bfloat16" else 1e-6)
        lr = jopt.warmup_cosine(jo.step, peak_lr=1e-2, warmup_steps=1, total_steps=3)
        tlr = topt.warmup_cosine(to.step, peak_lr=1e-2, warmup_steps=1, total_steps=3)
        jp, jo = jopt.apply_updates(cfg, jp, jg, jo, lr=lr)
        same_p = tp
        tp, to = topt.apply_updates(tcfg, tp, tg, to, lr=tlr)
        assert tp is same_p  # updated in place
        assert int(to.step) == int(jo.step) == i + 1 and to.step.dtype == torch.int32
        assert_trees_close(jo.mu, to.mu, 1e-6)
        assert_trees_close(jo.nu, to.nu, 1e-6)
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert t.dtype == getattr(torch, dtype)
            d = np.abs(t.float().numpy() - np.asarray(j, np.float32))
            if dtype == "bfloat16":  # one rounding of bf16 at most
                assert (d <= 2**-8 * np.abs(np.asarray(j, np.float32)) + 1e-30).all()
            else:
                assert d.max() <= 1e-6 * np.abs(np.asarray(j)).max()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small", "llama-3.2-vision-11b"])
def test_synthetic_batches_bit_for_bit(arch):
    cfg = tcfgs.smoke_config(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=48, global_batch=3, seed=5,
              frontend_tokens=cfg.frontend_tokens,
              frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend_tokens else 0)
    for step in (0, 1, 17):
        want, got = JSyntheticLM(**kw).batch(step), TSyntheticLM(**kw).batch(step)
        assert want.keys() == got.keys() == ({"tokens", "frontend"} if cfg.frontend_tokens
                                             else {"tokens"})
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_tree_helpers_keep_named_tuples_and_jax_order():
    jp = jax.tree.map(np.asarray, _tree(np.random.default_rng(1), np.float32))
    state = opt_state_from_jax(jopt.AdamWState(step=np.int32(4), mu=jp, nu=jp))
    assert isinstance(state, topt.AdamWState) and state.step.dtype == torch.int32
    assert int(state.step) == 4
    mapped = tree_map(lambda t: t + 1, state)
    assert type(mapped) is topt.AdamWState
    leaves = tree_leaves(state)
    for t, j in zip(leaves, jax.tree.leaves(jopt.AdamWState(np.int32(4), jp, jp))):
        assert np.array_equal(t.numpy(), np.asarray(j))
    rebuilt = tree_unflatten(state, [t * 2 for t in leaves])
    assert type(rebuilt) is topt.AdamWState and rebuilt.mu["final_norm"] is None
    assert torch.equal(rebuilt.mu["embed"]["tok"], 2 * state.mu["embed"]["tok"])


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_train_step_microbatches_match_reference(accum):
    """llama3.2-1b, f32, B=4 in two microbatches, three steps: the mean loss,
    grad_norm and lr each step (the only metrics the reference keeps) and the
    parameters at 1e-4; the moments at 1e-4 with f32 accumulation, and with
    bf16 accumulation at one bf16 rounding (2^-8) of the leaf's largest
    magnitude: the moments take the summed gradient as rounded to bf16, and
    two f32 gradients that differ in their last bits can round to
    neighbouring bf16 values.  The accumulation dtype is honoured: the
    port's moments lie far closer to the reference's in the same dtype than
    to the reference's in the other (one bf16 rounding of every summed
    gradient apart)."""
    other = {"float32": "bfloat16", "bfloat16": "float32"}[accum]
    kw = dict(steps=3, global_batch=4, n_microbatches=2)
    jms, tms, (jp, jo), (tp, to) = run_both("llama3.2-1b", grad_accum_dtype=accum, **kw)
    for jm, tm in zip(jms, tms):
        assert jm.keys() == tm.keys() == {"loss", "grad_norm", "lr"}
        for k in jm:
            assert abs(tm[k] - jm[k]) <= 1e-4 * max(abs(jm[k]), 1.0), (k, tm[k], jm[k])
    assert_trees_close(jp, tp)
    moment_tol = 2**-8 if accum == "bfloat16" else 1e-4
    for jtree, ttree in ((jo.mu, to.mu), (jo.nu, to.nu)):
        assert_trees_close(jtree, ttree, moment_tol)
    _, _, _, (_, to_other) = run_both("llama3.2-1b", grad_accum_dtype=other, **kw)
    for moment in ("mu", "nu"):
        mine, theirs = getattr(jo, moment), getattr(to_other, moment)
        assert abs_diff_sum(mine, getattr(to, moment)) < 0.1 * abs_diff_sum(mine, theirs)


def test_train_step_bf16_matches_reference():
    """llama3.2-1b with its bf16 weights, three steps (warmup 1: the first
    moves no weight, so the third step's loss is taken on weights the second
    updated in place): loss within 5e-2 and grad_norm within 2% each step;
    after the last update every parameter leaf within one bf16 rounding
    (2^-8) of its largest magnitude, and the port's weights far closer to
    the reference's than the two updates moved the reference's."""
    jms, tms, (jp, _), (tp, _) = run_both("llama3.2-1b", steps=3, dtype="bfloat16")
    for jm, tm in zip(jms, tms):
        assert abs(tm["loss"] - jm["loss"]) <= 5e-2
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 0.02 * jm["grad_norm"]
        assert tm["lr"] == pytest.approx(jm["lr"], rel=1e-6)
    assert jms[0]["lr"] == 0.0 and jms[1]["lr"] > 0.0
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    assert_trees_close(jp, tp, 2**-8)
    jp0 = start(configs("llama3.2-1b", "bfloat16")[0])[0]
    assert abs_diff_sum(jp, tp) < 0.05 * abs_diff_sum(jp, jp0)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``block``, ``dots`` and ``none`` (and the booleans): the same loss,
    aux and gradients bit for bit; in backward, ``block`` recomputes the
    forward's products, ``dots`` only its batched ones (the projections'
    outputs are kept) and ``none`` nothing.  mixtral's aux loss is not
    counted twice by the recomputation."""
    _, tc = configs(arch)
    jp = jax.tree.map(np.asarray, jax.jit(jinit_params, static_argnums=0)(
        configs(arch)[0], jax.random.PRNGKey(0)))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, tc.vocab_size, (2, 16)))
    out = {}
    for remat in ("none", False, "block", True, "dots"):
        leaves = [t.requires_grad_() for t in tree_leaves(params_from_jax(jp))]
        params = tree_unflatten(params_from_jax(jp), leaves)
        loss, metrics = next_token_loss(tc, params, tokens, remat=remat)
        with _CountProducts() as counted:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out[remat] = (loss, metrics["aux"], grads, counted.counts)
    ref_loss, ref_aux, ref_grads, ref_counts = out["none"]
    if tc.is_moe:
        assert float(ref_aux.detach()) > 0
    for remat, (loss, aux, grads, counts) in out.items():
        assert torch.equal(loss, ref_loss) and torch.equal(aux, ref_aux), remat
        assert all(torch.equal(g, r) for g, r in zip(grads, ref_grads)), remat
    assert out[False][3] == ref_counts and out[True][3] == out["block"][3]
    block, dots = out["block"][3], out["dots"][3]
    assert block["mm"] > ref_counts["mm"] and block["bmm"] > ref_counts["bmm"]
    assert dots["mm"] == ref_counts["mm"] and dots["bmm"] == block["bmm"]


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_frontend_dtype_refused_as_the_reference_fails(arch):
    """bf16 smoke weights: an f32 frontend (``SyntheticLM``'s draw) stops the
    reference's train step (its scan carry turns f32) and the port refuses
    it, in ``train_step`` and in ``launch.train.run``; with the frontend in
    bf16 both packages train, to the same loss within bf16 rounding."""
    jc, tc = configs(arch, "bfloat16")
    jr, tr = run_configs(jc, tc)
    batch = {k: v for k, v in JSyntheticLM(
        vocab_size=jc.vocab_size, seq_len=16, global_batch=2, seed=0,
        frontend_tokens=jc.frontend_tokens,
        frontend_dim=jc.frontend_dim or jc.d_model).batch(0).items()}
    assert batch["frontend"].dtype == np.float32
    jp = jax.jit(jinit_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="carry"):
        jtrain_step(jc, jr, jp, jopt.init_state(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    with pytest.raises(ValueError, match="reference"):
        ttrain_step(tc, tr, tp, topt.init_state(tp),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="reference"):
        ttrain.run(tc, tr, seed=0, steps=1, device="cpu")
    jms, tms, _, _ = run_both(arch, steps=1, dtype="bfloat16", frontend_dtype="bfloat16")
    assert np.isfinite(jms[0]["loss"]) and np.isfinite(tms[0]["loss"])
    assert abs(tms[0]["loss"] - jms[0]["loss"]) <= 5e-2


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv6", "rglru_scan"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """Before any device check: with grad mode on, an input that requires
    grad is refused (the kernel has no backward); without one, or under
    no_grad, the wrapper goes on to its own checks (a CPU tensor is refused
    there, as the kernel needs the card)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.rglru.kernel import rglru_scan
    from repro_torch.kernels.rwkv6.kernel import wkv6

    fn, shapes = {
        "flash_attention": (flash_attention, [(1, 2, 8, 32)] * 3),
        "wkv6": (wkv6, [(1, 8, 2, 32)] * 4 + [(2, 32)]),
        "rglru_scan": (rglru_scan, [(1, 8, 16)] * 2),
    }[kernel]
    inputs = [torch.zeros(s) for s in shapes]
    inputs[-1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*inputs)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*inputs)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*(t.detach() for t in inputs))

"""The port's ``train_step`` against the JAX package's, on JAX's own weights.

Shared by ``test_torch_train_archs_*.py`` (the ten smoke archs, split over
files so that the workers take them apart) and ``test_torch_train.py``.
Both packages take the same batches (``SyntheticLM``, numpy), the same
weights (``params_from_jax``; XATTN gates drawn non-zero first: at zero the
layer adds nothing) and a fresh AdamW state; each step's metrics, then
every parameter and moment leaf, are held at ``tol`` relative to the
leaf's (or metric's) largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM
from repro.models import init_params as jinit_params
from repro.models.steps import train_step as jtrain_step
from repro.optim import init_state as jinit_state
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models.convert import (
    draw_xattn_gates,
    opt_state_from_jax,
    params_from_jax,
    tree_leaves,
)
from repro_torch.models.steps import train_step as ttrain_step

TOL = 1e-4


def configs(arch: str, dtype: str = "float32"):
    jc = dataclasses.replace(jcfgs.smoke_config(arch), dtype=dtype)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), dtype=dtype)
    return jc, tc


def run_configs(jc, tc, **kw):
    kw = dict(dict(seq_len=16, global_batch=2, n_microbatches=1, warmup_steps=1,
                   total_steps=4), **kw)
    return JRunConfig(model=jc, **kw), TRunConfig(model=tc, **kw)


def data_for(cfg, run) -> SyntheticLM:
    return SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=run.seq_len, global_batch=run.global_batch, seed=0,
        frontend_tokens=cfg.frontend_tokens,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend_tokens else 0)


def start(jc, seed: int = 0):
    """(JAX params, JAX state, port params, port state): the same values."""
    jp = jax.tree.map(np.asarray, jax.jit(jinit_params, static_argnums=0)(
        jc, jax.random.PRNGKey(seed)))
    draw_xattn_gates(jp, np.random.default_rng(seed))
    tp = params_from_jax(jp)
    jp = jax.tree.map(jnp.asarray, jp)
    jo = jinit_state(jp)
    return jp, jo, tp, opt_state_from_jax(jax.tree.map(np.asarray, jo))


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def run_both(arch: str, steps: int = 2, dtype: str = "float32", frontend_dtype: str = "",
             **run_kw):
    """Train ``steps`` steps in both packages, the frontend (where the model
    has one) cast to ``frontend_dtype`` if given; returns the per-step
    metrics of each as floats and the final (params, state) of each."""
    jc, tc = configs(arch, dtype)
    jr, tr = run_configs(jc, tc, **run_kw)
    jp, jo, tp, to = start(jc)
    data = data_for(jc, jr)
    step = jax.jit(lambda p, o, b: jtrain_step(jc, jr, p, o, b))
    jms, tms = [], []
    for i in range(steps):
        batch = data.batch(i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        if "frontend" in batch and frontend_dtype:
            jb["frontend"] = jb["frontend"].astype(frontend_dtype)
            tb["frontend"] = tb["frontend"].to(getattr(torch, frontend_dtype))
        jp, jo, jm = step(jp, jo, jb)
        tp, to, tm = ttrain_step(tc, tr, tp, to, tb)
        jms.append({k: float(v) for k, v in jm.items()})
        tms.append({k: float(v) for k, v in tm.items()})
    return jms, tms, (jp, jo), (tp, to)


def assert_trees_close(jtree, ttree, tol: float = TOL) -> float:
    """Every leaf of the port's tree within ``tol`` of the JAX leaf's largest
    magnitude; returns the worst ratio."""
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    worst = 0.0
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape)
        err = rel_err(t, np.asarray(j, np.float32))
        assert err <= tol, (err, j.shape)
        worst = max(worst, err)
    return worst


def abs_diff_sum(a, b) -> float:
    """The sum over every element of |a - b|, for two trees of one structure,
    each of either package."""
    def arr(x):
        return x.detach().double().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x, np.float64)
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return float(sum(np.abs(arr(x) - arr(y)).sum() for x, y in zip(la, lb)))


def check_train_step(arch: str, steps: int = 2, tol: float = TOL, **run_kw) -> None:
    jms, tms, (jp, jo), (tp, to) = run_both(arch, steps=steps, **run_kw)
    for jm, tm in zip(jms, tms):
        assert jm.keys() == tm.keys()
        for k in jm:
            assert abs(tm[k] - jm[k]) <= tol * max(abs(jm[k]), 1.0), (k, tm[k], jm[k])
    assert jms[0]["lr"] == 0.0 and jms[-1]["lr"] > 0.0  # the last step moved the weights
    assert int(to.step) == int(jo.step) == steps
    for jtree, ttree in ((jp, tp), (jo.mu, to.mu), (jo.nu, to.nu)):
        assert_trees_close(jtree, ttree, tol)

"""The expert-parallel MoE layer (``moe_apply_sharded_inner`` through
``forward`` with a ``DistContext``) on an 8-process gloo world, held rank by
rank against the JAX package on 8 virtual CPU devices, on the reference's
check of ``tests/_multidevice_checks.py``: smoke dbrx, 4 experts in 2 FF
shards each (8 virtual experts), the reference's weights
(``init_params(ep_shards=2)`` from ``PRNGKey(0)``, carried across by
``params_from_jax``) and tokens (``randint`` from ``PRNGKey(1)``; (4, 16),
and (4, 64), where capacity factor 1.25 drops tokens: at 16 every slice of
8 tokens fits the least capacity of 8).  Each rank holds only its virtual
expert of each layer.

One world runs every case of ``repro_torch.sharding.checks.MOE_CASES``
while the reference runs ``tests/_torch_dist_reference.py`` in a
subprocess.  Against the reference's single-device ``forward`` (capacity
factor 8, no token dropped): 1e-4 in f32.  Against the reference's sharded
``forward``: ``direct``, ``chunked`` (2 chunks along C) on mesh (1, 8), and
``hierarchical`` on the expert axes ("data", "model") of a (2, 4) mesh, at
capacity factor 8 and at 1.25 with tokens dropped, at 1e-4 in f32, logits
and aux loss.  In bf16 the reference's 0.08 holds each package's sharded
layer to its own dense path: the two packages' bf16 dense paths already
differ by up to 0.74 at these tokens (a router near-tie that bf16 rounds
to another expert, as in ``test_torch_serve.py``'s dbrx bound).  The
layouts ``tp_adapt`` gives at tp 2 and tp 1 (ep_shards 1, one or two
devices on the expert axis) are refused by the port with a ValueError and
fail in the reference.  Two sharded train steps through the expert layer
(mesh (2, 4), the experts over "model") leave every rank with its blocks of
the reference's sharded step at 1e-4.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.transformer as jtf
import repro_torch.models.transformer as ttf
from repro_torch.launch.mesh import run_world
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import param_shapes
from repro_torch.sharding import checks
from repro_torch.sharding.specs import map_with_path, param_shardings

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
WORLD_TIMEOUT = 300.0
B = checks.MOE_BATCH
F32 = [c for c, v in checks.MOE_CASES.items() if v[2] == "float32" and "refused" not in c]
DENSE = [c for c in F32 if checks.MOE_CASES[c][3] == 8.0]
DROPPING = [c for c, v in checks.MOE_CASES.items() if v[3] < 8.0]
REFUSED = [c for c in checks.MOE_CASES if "refused" in c]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(port: one dict a rank, reference: name -> global output)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    src, dst = tmp / "inputs.npz", tmp / "reference.npz"
    vocab = jcfgs.smoke_config(checks.MOE_ARCH).vocab_size
    tokens = {S: np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, vocab),
                            np.int32) for S in checks.MOE_SEQS}
    train_tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (2, 8, checks.MOE_TRAIN_SEQ), 0, vocab), np.int32)
    np.savez(src, train_tokens=train_tokens, **{f"tokens{S}": t for S, t in tokens.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_reference.py"),
                            str(src), str(dst)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        params = {}
        for dtype in ("float32", "bfloat16"):
            jc = dataclasses.replace(jcfgs.smoke_config(checks.MOE_ARCH), dtype=dtype)
            jp = jtf.init_params(jc, jax.random.PRNGKey(0), ep_shards=2)
            params[dtype] = params_from_jax(jax.tree.map(np.asarray, jp))
        jp = jtf.init_params(dataclasses.replace(jcfgs.smoke_config(checks.MOE_ARCH),
                                                 dtype="float32"), jax.random.PRNGKey(0))
        inputs = {"params": params, "tokens": {S: torch.from_numpy(t) for S, t in tokens.items()},
                  "train_params": params_from_jax(jax.tree.map(np.asarray, jp)),
                  "train_tokens": torch.from_numpy(train_tokens)}
        port = run_world(checks.moe_program, checks.WORLD, inputs, device="cpu",
                         timeout=WORLD_TIMEOUT)
        # the port's own dense path in bf16, for the bf16 case
        cfg = dataclasses.replace(checks.moe_config("dense_bf16"), dtype="bfloat16")
        with torch.no_grad():
            dense_bf16 = ttf.forward(cfg, params["bfloat16"], inputs["tokens"][16])[0]
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
    return port, dict(np.load(dst)), dense_bf16.float().numpy()


def _slot(case: str, rank: int, x: np.ndarray) -> np.ndarray:
    """Rank ``rank``'s slot of a global batch: its share over the data axis
    where that divides the batch, else the whole."""
    (D, M) = checks.MOE_CASES[case][0]
    if D == 1 or B % D:
        return x
    d = rank // M
    return x[d * B // D:(d + 1) * B // D]


@pytest.mark.parametrize("case", DENSE)
def test_against_the_reference_single_device_forward(outputs, case):
    """No token is dropped at capacity factor 8, so every rank's slot is the
    reference's dense oracle's at 1e-4 in f32."""
    port, ref, _ = outputs
    want = ref[f"dense/float32/{checks.MOE_CASES[case][1]}"]
    for r in range(checks.WORLD):
        np.testing.assert_allclose(port[r][case]["logits"], _slot(case, r, want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", F32)
def test_against_the_reference_sharded_forward(outputs, case):
    """Every rank's slot of the logits and its aux loss equal the reference's
    sharded ``forward`` on the same mesh and strategy, at 1e-4 in f32."""
    port, ref, _ = outputs
    for r in range(checks.WORLD):
        got = port[r][case]
        np.testing.assert_allclose(got["logits"], _slot(case, r, ref[f"{case}/logits"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["aux"], ref[f"{case}/aux"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", DROPPING)
def test_capacity_drops_tokens(outputs, case):
    """At capacity factor 1.25 and 64 positions the reference's sharded layer
    drops tokens (its logits leave the dense oracle's), so the cases above
    hold the port's drops to the reference's."""
    _, ref, _ = outputs
    dense = ref[f"dense/float32/{checks.MOE_CASES[case][1]}"]
    assert float(np.abs(ref[f"{case}/logits"] - dense).max()) > 1e-2


def test_bf16_sharded_layer_within_the_references_tolerance_of_dense(outputs):
    """The reference's bf16 check: the sharded layer's logits within 0.08 of
    the dense path's, each package's own (both hold)."""
    port, ref, dense_bf16 = outputs
    assert float(np.abs(ref["dense_bf16/logits"] - ref["dense/bfloat16/16"]).max()) < 0.08
    for r in range(checks.WORLD):
        err = float(np.abs(port[r]["dense_bf16"]["logits"] - dense_bf16).max())
        assert err < 0.08, (r, err)


@pytest.mark.parametrize("case", REFUSED)
def test_unservable_layouts_are_refused(outputs, case):
    """tp_adapt's ep_shards 1 on an expert axis smaller than the expert
    count: the reference fails inside its layer; every rank of the port
    raises a ValueError that names the layout, before the layer's first
    collective."""
    port, ref, _ = outputs
    assert f"{case}/error" in ref, sorted(ref)
    for r in range(checks.WORLD):
        assert "must hold E x ep_shards = 4 devices" in port[r][case].get("error", ""), r


def test_sharded_train_step_through_the_expert_layer(outputs):
    """Two sharded train steps of smoke dbrx (f32, capacity factor 8) on a
    (2, 4) mesh, the experts over "model": every rank's blocks of the
    parameters and moments, and each step's loss, aux loss and global
    gradient norm, hold the reference's sharded step at 1e-4.  The
    gradients come back through the all-to-alls and the all-gather, and the
    router's and the token slices' gradients are summed over the expert
    axis (the reference's ``shard_map`` transposes)."""
    port, ref, _ = outputs
    cfg = checks.moe_train_run().model
    sizes = dict(zip(("data", "model"), checks.MOE_TRAIN_MESH))
    sh = param_shardings(param_shapes(cfg), sizes)
    for r in range(checks.WORLD):
        got = port[r]["train"]
        for step, m in enumerate(got["metrics"]):
            for k in ("loss", "aux", "grad_norm", "lr"):
                want = float(ref[f"train/metrics/{step}/{k}"])
                assert abs(m[k] - want) <= 1e-4 * max(abs(want), 1.0), (r, step, k)
        coord = {"data": r // sizes["model"], "model": r % sizes["model"]}
        for name in ("params", "mu", "nu"):
            def check(path, s, _name=name):
                want = s.shard(torch.from_numpy(ref[f"train/{_name}/{path}"]), coord=coord)
                have = _leaf(got[_name], path)
                err = float(np.abs(have - want.numpy()).max()
                            / max(float(want.abs().max()), 1e-30))
                assert err <= 1e-4, (r, _name, path, err)
            map_with_path(check, sh)


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (tuple, list)) else tree[key]
    return tree

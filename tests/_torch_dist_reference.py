"""The JAX package's outputs for the expert-parallel MoE checks, on 8
virtual CPU devices, for ``tests/test_torch_moe_ep.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_dist_reference.py INPUTS.npz OUTPUTS.npz

INPUTS holds the tokens (``tokens<S>``, one array a sequence length); the
weights are the reference's own ``init_params`` draw from ``PRNGKey(0)``,
as in the test.  OUTPUTS gets, for each case of
``repro_torch.sharding.checks.MOE_CASES``, the global logits and aux loss of the reference's ``forward`` with a ``DistContext``
(``<case>/logits``, ``<case>/aux``), or the name of the exception it raised
(``<case>/error``); its single-device ``forward``'s logits in each dtype
and at each sequence length (``dense/<dtype>/<S>``); and two sharded
``train_step``s of smoke dbrx in f32 on ``MOE_TRAIN_MESH`` from
``train_tokens`` (``train/params/...``, ``train/mu/...``, ``train/nu/...``
by path, ``train/metrics/<step>/<name>``).
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

try:  # jax >= 0.5
    from jax.sharding import AxisType
except ImportError:  # older jax: meshes are implicitly "auto"
    AxisType = None

from repro.configs import smoke_config
from repro.configs.base import RunConfig
from repro.models import forward, init_params
from repro.models.steps import train_step
from repro.models.transformer import DistContext
from repro.optim import init_state
from repro.sharding import specs
from repro_torch.sharding.checks import MOE_ARCH, MOE_CASES, MOE_SEQS, MOE_TRAIN_MESH


def mesh2(a, b, names):
    if AxisType is None:
        return jax.make_mesh((a, b), names)
    return jax.make_mesh((a, b), names, axis_types=(AxisType.Auto,) * 2)


def main(src: str, dst: str) -> None:
    assert len(jax.devices()) == 8, jax.devices()
    tokens = {S: jnp.asarray(np.load(src)[f"tokens{S}"]) for S in MOE_SEQS}
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke_config(MOE_ARCH), dtype=dtype, capacity_factor=8.0)
        params = init_params(cfg, jax.random.PRNGKey(0), ep_shards=2)
        for S in MOE_SEQS:
            out[f"dense/{dtype}/{S}"] = forward(cfg, params, tokens[S])[0]
    for case, (dims, S, dtype, cf, strategy, chunks, ep_axes, ep_shards) in MOE_CASES.items():
        cfg = dataclasses.replace(smoke_config(MOE_ARCH), dtype=dtype, capacity_factor=cf)
        params = init_params(cfg, jax.random.PRNGKey(0), ep_shards=ep_shards)
        dist = DistContext(mesh=mesh2(*dims, ("data", "model")), dp_axes=("data",),
                           ep_shards=ep_shards, moe_strategy=strategy, a2a_chunks=chunks,
                           ep_axes=ep_axes)
        try:
            logits, aux = jax.jit(lambda p, t: forward(cfg, p, t, dist=dist))(params, tokens[S])
        except Exception as e:  # the layouts it cannot serve: recorded, not raised
            out[f"{case}/error"] = np.array(type(e).__name__)
            continue
        out[f"{case}/logits"], out[f"{case}/aux"] = logits, aux
    # the sharded train step through the expert layer, two steps
    tcfg = dataclasses.replace(smoke_config(MOE_ARCH), dtype="float32", capacity_factor=8.0)
    run = RunConfig(model=tcfg, n_microbatches=1, remat=False, warmup_steps=1,
                    total_steps=10, learning_rate=1e-3)
    mesh = mesh2(*MOE_TRAIN_MESH, ("data", "model"))
    dist = DistContext(mesh=mesh, dp_axes=("data",))
    params = init_params(tcfg, jax.random.PRNGKey(0))
    params = jax.device_put(params, specs.param_shardings(params, mesh))
    opt = init_state(params)
    step = jax.jit(lambda p, o, b: train_step(tcfg, run, p, o, b, dist=dist))
    for i, toks in enumerate(np.load(src)["train_tokens"]):
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(toks)})
        for k, v in m.items():
            out[f"train/metrics/{i}/{k}"] = v
    for path, v in jax.tree_util.tree_leaves_with_path({"params": params, "mu": opt.mu,
                                                        "nu": opt.nu}):
        out["train/" + specs._path_str(path)] = v
    arrays = {k: np.asarray(v) for k, v in out.items()}
    np.savez(dst, **{k: v if v.dtype.kind == "U" else v.astype(np.float32)
                     for k, v in arrays.items()})
    print("REFERENCE_OK", len(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

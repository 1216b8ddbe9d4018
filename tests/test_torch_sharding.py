"""The port's sharding rules (``repro_torch.sharding.specs``) against the
JAX package's, without processes.

For every arch at full width, on the production meshes (16, 16) and
(2, 16, 16) and on (2, 4), with FSDP on and off, every parameter leaf's
spec equals the reference's: the reference's shapes and paths come from
``jax.eval_shape(init_params)``, the port's from its ``init_params`` on the
meta device, each for the config and ``ep_shards`` that ``tp_adapt`` gives
at the mesh's model axis.  Meshes are axis sizes: a ``{axis: size}``
mapping for the port, a ``jax.sharding.AbstractMesh`` for the reference's
``NamedSharding`` trees.  The same holds for ``opt_shardings``,
``cache_shardings`` (the caches of ``init_caches`` at B=4 and B=1),
``batch_sharding`` and ``tp_adapt`` at tp 2, 4, 8 and 16.  ``Sharding``'s
``shard`` cuts each rank's block; the expert-parallel layer's refusal of
the layouts ``tp_adapt`` gives where the expert count is a multiple of the
model axis is held for both packages (the reference's own failure is in
``test_torch_moe_ep.py``).
"""
import dataclasses
import functools
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jcfgs
import repro.models.decode as jdec
import repro.models.transformer as jtf
import repro.sharding.specs as jspecs
import repro_torch.configs as tcfgs
import repro_torch.models.decode as tdec
import repro_torch.models.transformer as ttf
import repro_torch.sharding.specs as tspecs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro.configs.base import RunConfig as JRunConfig
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ARCHS = sorted(jcfgs.ARCHS)
MESHES = [(16, 16), (2, 16, 16), (2, 4)]


def _names(dims):
    return ("pod", "data", "model")[-len(dims):]


def _norm(spec) -> tuple:
    """A spec's entries with trailing Nones dropped (``NamedSharding`` keeps
    them or not by version) and a tuple of one axis read as the axis (JAX's
    ``PartitionSpec`` reads it so)."""
    entries = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _jax_paths(tree) -> dict:
    return {jspecs._path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_paths(tree) -> dict:
    out = {}
    tspecs.map_with_path(lambda p, v: out.__setitem__(p, v), tree)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch: str, tp: int):
    """(the reference's and the port's tp_adapt results, and their
    parameter shape trees)."""
    jc, jr = jspecs.tp_adapt(jcfgs.get_config(arch), tp)
    tc, tr = tspecs.tp_adapt(tcfgs.get_config(arch), tp)
    jshape = jax.eval_shape(functools.partial(jtf.init_params, jc, ep_shards=jr),
                            jax.random.PRNGKey(0))
    return (jc, jr), (tc, tr), jshape, ttf.param_shapes(tc, tr)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, dims, fsdp):
    sizes = dict(zip(_names(dims), dims))
    (jc, jr), (tc, tr), jshape, tshape = _shapes(arch, sizes["model"])
    assert jr == tr and dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jleaves, tleaves = _jax_paths(jshape), _port_paths(tshape)
    assert sorted(jleaves) == sorted(tleaves)
    for path, leaf in jleaves.items():
        assert tuple(tleaves[path].shape) == tuple(leaf.shape), path
        want = jspecs.param_spec(path, leaf.shape, _Mesh(sizes), fsdp=fsdp)
        got = tspecs.param_spec(path, tuple(leaf.shape), sizes, fsdp=fsdp)
        assert tuple(got) == tuple(want), (path, got, want)


class _Mesh:
    """What the reference's rules read of a mesh: its axis sizes (its own
    tests pass a ``SimpleNamespace(shape=...)``)."""

    def __init__(self, sizes):
        self.shape = sizes


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_param_and_opt_shardings_trees_match(arch, dims):
    """``param_shardings`` and ``opt_shardings`` over the whole tree: the
    same spec at every path, moments like the parameters, the step
    replicated."""
    sizes = dict(zip(_names(dims), dims))
    _, _, jshape, tshape = _shapes(arch, sizes["model"])
    amesh = AbstractMesh(dims, _names(dims))
    jopt = jspecs.opt_shardings(jshape, amesh)
    topt = tspecs.opt_shardings(tshape, sizes)
    assert _norm(topt.step.spec) == _norm(jopt.step.spec) == ()
    for jtree, ttree in ((jspecs.param_shardings(jshape, amesh),
                          tspecs.param_shardings(tshape, sizes)),
                         (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
        jp, tp = _jax_paths(jtree), _port_paths(ttree)
        assert sorted(jp) == sorted(tp)
        for path in jp:
            assert _norm(tp[path].spec) == _norm(jp[path].spec), path


def _cut(cfg):
    """Two repetitions of each group: the caches' specs do not depend on
    the depth."""
    return dataclasses.replace(cfg, groups=tuple(dataclasses.replace(g, count=min(g.count, 2))
                                                 for g in cfg.groups))


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match(arch, dims, batch):
    """The decode caches at full width, B=4 (batch over the data axes where
    it divides) and B=1 (the sequence over "data" instead)."""
    tcaches = tdec.init_caches(_cut(tcfgs.get_config(arch)), batch, 4096, device="meta")
    jcaches = jax.eval_shape(functools.partial(jdec.init_caches, _cut(jcfgs.get_config(arch)),
                                               batch, 4096))
    names = _names(dims)
    dp = tuple(a for a in ("pod", "data") if a in names)
    jsh = _jax_paths(jspecs.cache_shardings(jcaches, AbstractMesh(dims, names), dp_axes=dp))
    tsh = _port_paths(tspecs.cache_shardings(tcaches, dict(zip(names, dims)), dp_axes=dp))
    assert sorted(jsh) == sorted(tsh)
    for path in jsh:
        assert _norm(tsh[path].spec) == _norm(jsh[path].spec), path


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_batch_sharding_matches(dims, batch):
    names = _names(dims)
    dp = tuple(a for a in ("pod", "data") if a in names)
    want = jspecs.batch_sharding(AbstractMesh(dims, names), batch, 3, dp)
    got = tspecs.batch_sharding(dict(zip(names, dims)), batch, 3, dp)
    assert _norm(got.spec) == _norm(want.spec)


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_adapt_matches(arch, tp):
    jc, jr = jspecs.tp_adapt(jcfgs.get_config(arch), tp)
    tc, tr = tspecs.tp_adapt(tcfgs.get_config(arch), tp)
    assert jr == tr
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_shard_cuts_each_ranks_block_and_the_blocks_tile_the_leaf():
    """Each rank's block by its coordinates: the blocks of every rank put
    back in place give the leaf, a tuple entry split row-major over its
    axes."""
    sizes = {"data": 2, "model": 4}
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    for spec in (tspecs.P(("data", "model"), None, None), tspecs.P("data", "model", None),
                 tspecs.P(None, "model", None), tspecs.P()):
        sh = tspecs.Sharding(sizes, spec if len(spec) else tspecs.P(None, None, None))
        seen = torch.zeros_like(x)
        for d in range(2):
            for m in range(4):
                blk = sh.shard(x, coord={"data": d, "model": m})
                idx = []
                for dim, entry in enumerate(sh.spec):
                    axes = () if entry is None else (entry if isinstance(entry, tuple)
                                                     else (entry,))
                    k, i = 1, 0
                    for a in axes:
                        i = i * sizes[a] + {"data": d, "model": m}[a]
                        k *= sizes[a]
                    n = x.shape[dim] // k
                    idx.append(slice(i * n, (i + 1) * n))
                seen[tuple(idx)] = blk
                assert torch.equal(blk, x[tuple(idx)])
        assert torch.equal(seen, x)
        used = {a for e in sh.spec if e for a in (e if isinstance(e, tuple) else (e,))}
        assert sh.replicas == math.prod(n for a, n in sizes.items() if a not in used)


@pytest.mark.parametrize("arch,dims", [("mixtral-8x22b", (1, 4)), ("mixtral-8x22b", (4, 2)),
                                       ("mixtral-8x22b", (4, 1)), ("dbrx-132b", (2, 8))])
def test_tp_adapt_layouts_the_expert_layer_cannot_serve_are_refused(arch, dims):
    """tp_adapt gives ep_shards 1 whenever the expert count is a multiple of
    the model axis (or the axis is 1): mixtral at tp 4, on the reference's
    default 8-device mesh (4, 2), on a data-only mesh; dbrx (16 experts) at
    tp 8.  The sharded layer serves one virtual expert a device, so the
    port refuses each with a ValueError that names the layout."""
    tp = dims[-1]
    jc, jr = jspecs.tp_adapt(jcfgs.get_config(arch), tp)
    tc, tr = tspecs.tp_adapt(tcfgs.get_config(arch), tp)
    assert jr == tr == 1 and tp != tc.n_experts
    with pytest.raises(ValueError, match=f"must hold E x ep_shards = {tc.n_experts} devices"):
        tmoe.check_ep_layout(tc, tp, tr)


def test_expert_block_init_keeps_the_whole_draws_rows():
    """``init_params(expert_block=...)`` draws every matrix in the
    single-device order and keeps its rows: each block equals the whole
    draw's rows, every other leaf equals the whole draw's."""
    cfg = tcfgs.smoke_config("mixtral-8x22b")
    whole = ttf.init_params(cfg, torch.Generator().manual_seed(3), ep_shards=2)
    for start in range(0, 8, 3):
        part = ttf.init_params(cfg, torch.Generator().manual_seed(3), ep_shards=2,
                               expert_block=(start, min(3, 8 - start)))
        for path, leaf in _port_paths(part).items():
            want = _port_paths(whole)[path]
            if path.endswith(("moe/w_in", "moe/w_out")):
                want = want[:, start:start + leaf.shape[1]]
            assert torch.equal(leaf, want), path


def test_run_config_has_the_references_fields_and_defaults():
    """Every field of the port's ``RunConfig`` is the reference's, with its
    default, and the distribution fields are among them."""
    jf = {f.name: f for f in dataclasses.fields(JRunConfig)}
    for f in dataclasses.fields(TRunConfig):
        assert f.name in jf, f.name
        assert f.default == jf[f.name].default, f.name
    names = {f.name for f in dataclasses.fields(TRunConfig)}
    assert {"fsdp", "grad_allreduce", "moe_alltoall", "grad_compression"} <= names

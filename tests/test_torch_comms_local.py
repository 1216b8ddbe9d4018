"""The collectives' single-process pieces against the JAX package
(``chunked_collective``, ``microbatched_grads``, the int8 quantizers), and
the mesh helpers and the world helper of ``repro_torch.launch.mesh`` on
small gloo worlds on the CPU: their errors, a rank that raises, a world
that outlives its timeout, and the collective timers' agreed counts."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms.overlap import chunked_collective as ref_chunked
from repro.comms.overlap import microbatched_grads as ref_microbatched
from repro.optim import compress as ref_compress
from repro_torch.comms import routes
from repro_torch.comms.overlap import chunked_collective, microbatched_grads
from repro_torch.launch.mesh import run_world
from repro_torch.optim import compress

import _torch_comms_world as world_programs

torch.set_num_threads(1)


# -- chunked_collective: tests/test_overlap.py's cases, both packages ----------

CHUNK_CASES = {
    "divisible_fast_path": ((lambda p: 2 * p, lambda p: 2 * p),
                            np.arange(8, dtype=np.float32).reshape(2, 4), 2, {}),
    "padded_identity": ((lambda p: p, lambda p: p),
                        np.arange(10, dtype=np.float32).reshape(2, 5), 2, {}),
    "size_multiplying_unpads_per_block": (
        (lambda p: jnp.concatenate([p, p], axis=1), lambda p: torch.cat([p, p], dim=1)),
        np.asarray([[1.0, 2.0, 3.0]], np.float32), 2, {}),
    "non_additive_with_identity_pad": (
        (lambda p: jnp.full_like(p, p.min()), lambda p: torch.full_like(p, p.min())),
        np.asarray([[5.0, 4.0, 3.0]], np.float32), 2, {"pad_value": np.inf}),
    "pure_padding_chunk_dropped": ((lambda p: p, lambda p: p),
                                   np.asarray([[7.0, 9.0]], np.float32), 4, {}),
    "axis_0_of_a_slot": ((lambda p: p * 3.0, lambda p: p * 3.0),
                         np.arange(15, dtype=np.float32).reshape(5, 3), 2, {"axis": 0}),
}
CHUNK_ERRORS = {
    "non_additive_rejected_without_identity": (
        (lambda p: p, lambda p: p), {"pad_value": None}, "not divisible"),
    "non_integer_growth_rejected": (
        (lambda p: jnp.concatenate([p, p[:, :1]], axis=1),
         lambda p: torch.cat([p, p[:, :1]], dim=1)), {}, "integer multiple"),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_collective_matches_reference(case):
    (jfn, tfn), x, n_chunks, kw = CHUNK_CASES[case]
    want = np.asarray(ref_chunked(jfn, jnp.asarray(x), n_chunks, **kw))
    got = chunked_collective(tfn, torch.from_numpy(x), n_chunks, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CHUNK_ERRORS))
def test_chunked_collective_refuses_as_the_reference(case):
    (jfn, tfn), kw, match = CHUNK_ERRORS[case]
    x = np.asarray([[5.0, 4.0, 3.0]], np.float32)
    with pytest.raises(ValueError, match=match):
        ref_chunked(jfn, jnp.asarray(x), 2, axis=1, **kw)
    with pytest.raises(ValueError, match=match):
        chunked_collective(tfn, torch.from_numpy(x), 2, axis=1, **kw)


# -- microbatched_grads --------------------------------------------------------

def _loss():
    def jloss(p, b):
        h = jnp.tanh(b["x"] @ p["w"] + p["b"])
        return jnp.mean((h - b["y"]) ** 2) + 0.01 * jnp.sum(p["w"] ** 2)

    def tloss(p, b):
        h = torch.tanh(b["x"] @ p["w"] + p["b"])
        return torch.mean((h - b["y"]) ** 2) + 0.01 * torch.sum(p["w"] ** 2)

    return jloss, tloss


@pytest.mark.parametrize("reduce_each", [False, True])
def test_microbatched_grads_match_reference(reduce_each):
    """Four microbatches of a small loss, the parameters carried through
    every microbatch; ``reduce_each`` (an affine map here, so applying it
    before or after the accumulation differs) runs on each microbatch's
    gradients before they are added, as in the reference."""
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 4)).astype(np.float32),
             "y": rng.standard_normal((8, 3)).astype(np.float32)}
    jloss, tloss = _loss()
    jred = (lambda g: jax.tree.map(lambda t: 0.5 * t + 1.0, g)) if reduce_each else None
    tred = (lambda g: {k: 0.5 * v + 1.0 for k, v in g.items()}) if reduce_each else None
    jl, jg = ref_microbatched(jloss, jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, batch), 4, reduce_each=jred)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tl, tg = microbatched_grads(tloss, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                4, reduce_each=tred)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    for k in params:
        assert tg[k].dtype == torch.float32 and tg[k].shape == tp[k].shape
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tp[k].numpy(), params[k])  # untouched


# -- int8 quantizers -----------------------------------------------------------

def _draws():
    rng = np.random.default_rng(7)
    # halves at a scale of exactly 1 (max |x| = 127): round half to even
    ties = (np.arange(-254, 255) / 2.0).astype(np.float32)
    return {"ragged": (rng.standard_normal((3, 700)).astype(np.float32), 1024),
            "one_block": (rng.standard_normal(2048).astype(np.float32) * 3, 1024),
            "small_block": (rng.standard_normal((5, 64)).astype(np.float32), 256),
            "half_ties": (ties, 512),
            "zeros": (np.zeros(300, np.float32), 128)}


@pytest.mark.parametrize("draw", sorted(_draws()))
def test_quantizers_match_reference_leaf_for_leaf(draw):
    x, block = _draws()[draw]
    err = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32) * 1e-3
    jq, js = ref_compress.quantize_int8(jnp.asarray(x), block)
    tq, ts = compress.quantize_int8(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compress.dequantize_int8(tq, ts, x.shape, block).numpy(),
        np.asarray(ref_compress.dequantize_int8(jq, js, x.shape, block)))
    want = ref_compress.quantize_with_feedback(jnp.asarray(x), jnp.asarray(err), block)
    got = compress.quantize_with_feedback(torch.from_numpy(x), torch.from_numpy(err), block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the mesh helpers and the world helper -------------------------------------

@pytest.fixture(scope="module")
def mesh_world():
    return run_world(world_programs.mesh_program, 4, device="cpu", timeout=240)


def test_make_mesh_refuses_a_wrong_world_size(mesh_world):
    for r in mesh_world:
        assert "the world has 4 ranks" in r["wrong_size"] and "needs 8" in r["wrong_size"]
        assert "needs 256" in r["production"] and "needs 512" in r["production_multi"]


def test_mesh_axes_and_groups(mesh_world):
    for rank, r in enumerate(mesh_world):
        assert r["axes"] == {"pod": 2, "data": 2}
        assert r["dp"] == ("pod", "data") and r["dp3"] == ("pod", "data")
        assert "mesh's order" in r["order"] and "not distinct axes" in r["unknown"]
        # mesh (1, 2, 2): rank = data * 2 + model
        data, model = divmod(rank, 2)
        assert r["index"] == {"pod/data": data, "data/model": rank, "pod/model": model,
                              "pod/data/model": rank}
        assert r["group_size"] == {"pod/data": 2, "data/model": 4, "pod/model": 2,
                                   "pod/data/model": 4}


def test_collective_timers_agree_on_counts(mesh_world):
    """bench_allreduce returns the reference's one entry; ranks whose first
    calls took different times made the same number of calls (else the
    world would hang)."""
    for r in mesh_world:
        sizes, times = r["bench"]["allreduce_flat"]
        assert list(r["bench"]) == ["allreduce_flat"] and sizes == [1 << 12, 1 << 16]
        assert all(t > 0 for t in times)
    assert len({r["calls"] for r in mesh_world}) == 1


def test_run_world_reports_a_rank_that_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as e:
        run_world(world_programs.raise_on_rank_1, 2, device="cpu", timeout=120)
    assert "rank 1 fails on purpose" in str(e.value)
    assert time.monotonic() - t0 < 120


def test_run_world_kills_a_world_past_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        run_world(world_programs.sleep_forever, 2, device="cpu", timeout=8)
    assert time.monotonic() - t0 < 30


def test_run_world_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_world(world_programs.sleep_forever, 2)


# -- the route table -------------------------------------------------------------

ROUTE_CASES = [("gloo", "cpu", "send_recv", "direct"), ("gloo", "cuda", "send_recv", "staged"),
               ("nccl", "cuda", "all_to_all", "direct"), ("fake", "meta", "all_gather", "direct"),
               ("fake", "cpu", "send_recv", "direct"), ("fake", "cuda", "all_reduce", None),
               ("nccl", "cpu", "all_reduce", None), ("mpi", "cpu", "all_gather", None),
               ("gloo", "cpu", "broadcast", None)]


@pytest.mark.parametrize("backend, device, op, want", ROUTE_CASES)
def test_route_table_keys_and_a_missing_key_raises(monkeypatch, backend, device, op, want):
    """The fake backend's keys (the dry-run's world) are direct on meta and
    CPU tensors; a key the table lacks still raises, naming it."""
    monkeypatch.setattr(routes.dist, "get_backend", lambda group: group)
    if want is None:
        with pytest.raises(NotImplementedError, match=f"no route for \\('{backend}'"):
            routes.route(backend, torch.device(device), op)
    else:
        assert routes.route(backend, torch.device(device), op) == want

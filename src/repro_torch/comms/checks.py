"""The collectives driven across a world: one rank's programs for
``repro_torch.launch.mesh.run_world``.

:func:`run_checks` is the reference's multi-device checks
(``tests/_multidevice_checks.py``, from the all-reduces to the chunked
collective) as one rank's program: every public wrapper and ``*_inner`` at
the checks' shapes, on inputs :func:`check_inputs` draws with numpy (at a
world of 8, the reference's own draw), each returning this rank's slot.
The tests hold the slots against the reference's global outputs; on the
card, a world on CUDA tensors is held against a world on the host.

:func:`full_width` reduces one model's whole f32 gradient with each
strategy, :func:`fit` times the strategies and fits postal models, and
:func:`identity` runs every strategy on a one-rank world.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comms.allgather import all_gather_axis
from repro_torch.comms.allreduce import (
    allreduce,
    allreduce_flat,
    allreduce_flat_inner,
    allreduce_hier_inner,
    allreduce_hierarchical,
    allreduce_ring,
    allreduce_ring_inner,
    auto_allreduce_strategy,
    reduce_scatter,
)
from repro_torch.comms.alltoall import (
    alltoall,
    alltoall_direct,
    alltoall_direct_inner,
    alltoall_hier_inner,
    alltoall_hierarchical,
    auto_alltoall_strategy,
)
from repro_torch.comms.overlap import chunked_collective
from repro_torch.comms.p2p import halo_exchange, ring_shift
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.compress import (
    compressed_allreduce,
    compressed_allreduce_slow_inner,
    quantize_int8,
)

# per-replica payloads of the strategy-pick sweep: one octave apart
ALLREDUCE_PICK_ELEMS = tuple(2 ** j for j in range(0, 29))
ALLTOALL_PICK_ELEMS = tuple(2 ** j for j in range(0, 25))
STRATEGIES = ("flat", "hierarchical", "ring")


def check_inputs(world: int) -> Dict[str, np.ndarray]:
    """The checks' global inputs (leading dim: one slot a rank), drawn in the
    reference's order; ``xe`` holds multiples of 2^-10, whose sums over a
    few ranks are exact in f32."""
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "x": f32(rng.standard_normal((world, 16, 5))),
        "xr": f32(rng.standard_normal((world, 24))),
        "blocks": f32(rng.standard_normal((world, world, 3))),
        "halo": f32(rng.standard_normal((world, 6, 2))),
        "xc": f32(rng.standard_normal((world, 2048))),
        "xe": f32(rng.integers(-2048, 2049, (world, 2048)) * 2.0 ** -10),
    }


def a2a_shapes(world: int):
    """(outer, inner) meshes of the all-to-all checks: sizes that differ."""
    return sorted({(2, world // 2), (world // 2, 2)})


def hold(world: int) -> Dict[str, str]:
    """How each output of :func:`run_checks` is held against another run's
    or the reference's: ``equal`` (data movement, the ring all-reduce in the
    reference's order, the picks, the int8s and scales of the exact draw),
    ``1e-5`` (sums in another order: the reference's tolerance), ``1e-6``
    (the exact draw's compressed output) or ``bound`` (compression at the
    reference's draw: within ``2·shard_max/254 + 1e-6`` of the true sum)."""
    kinds = {n: "equal" for n in (
        "allreduce_ring", "allreduce_ring_inner", "allreduce_ring_padded", "ring_shift",
        "ring_shift_3", "halo_exchange", "all_gather_axis", "all_gather_axis_dim1",
        "alltoall_auto", "compressed_exact_q", "compressed_exact_s", "auto_allreduce_picks",
        "auto_alltoall_picks")}
    kinds.update({f"alltoall_{kind}_{o}x{i}": "equal" for o, i in a2a_shapes(world)
                  for kind in ("direct", "direct_inner", "hierarchical", "hier_inner")})
    kinds.update({n: "1e-5" for n in (
        "allreduce_flat", "allreduce_flat_inner", "allreduce_hierarchical",
        "allreduce_hier_inner", "allreduce_auto", "reduce_scatter", "chunked_collective")})
    kinds.update(compressed_exact="1e-6", compressed_allreduce="bound",
                 compressed_allreduce_slow_inner="bound")
    return kinds


def disagreement(name: str, got, want, world: int) -> str:
    """Empty when one rank's ``got`` holds against ``want`` as :func:`hold`
    says, else what differs.  ``bound`` ignores ``want``: it holds ``got``
    against the true sum of the inputs."""
    kind = hold(world)[name]
    got, want = np.asarray(got), np.asarray(want)
    if kind == "bound":
        xc = check_inputs(world)["xc"]
        shard_max = np.abs(xc.reshape(2, world // 2, -1).sum(1)).max()
        err = float(np.abs(got - xc.sum(0)).max())
        limit = 2 * shard_max / 254 + 1e-6
        return "" if err <= limit else f"{name}: error {err} over the bound {limit}"
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{name}: {got.dtype}{got.shape} against {want.dtype}{want.shape}"
    if kind == "equal":
        return "" if np.array_equal(got, want) else f"{name}: not equal"
    tol = float(kind)
    d = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    return "" if np.allclose(got, want, rtol=tol, atol=tol) else f"{name}: differs by {d}"


def run_checks(device: torch.device, world: int) -> Dict[str, object]:
    """This rank's outputs of every check, by name."""
    r = dist.get_rank()
    inp = {k: torch.from_numpy(v).to(device) for k, v in check_inputs(world).items()}
    dt = device.type
    main = make_mesh((2, world // 2), ("pod", "data"), dt)
    ring = make_mesh((1, world), ("pod", "data"), dt)
    a2a = {s: make_mesh(s, ("outer", "inner"), dt) for s in a2a_shapes(world)}
    dp = ("pod", "data")
    x, xr, xc, xe = inp["x"][r], inp["xr"][r], inp["xc"][r], inp["xe"][r]
    w = 24 // world  # this rank's columns of xr
    out: Dict[str, object] = {
        "allreduce_flat": allreduce_flat(x, main, dp),
        "allreduce_flat_inner": allreduce_flat_inner(x, main, dp),
        "allreduce_hierarchical": allreduce_hierarchical(x, main, "pod", ("data",)),
        "allreduce_hier_inner": allreduce_hier_inner(x, main, "pod", ("data",)),
        "allreduce_auto": allreduce(x, main, strategy="auto"),
        "allreduce_ring": allreduce_ring(xr, ring, "data"),
        "allreduce_ring_inner": allreduce_ring_inner(xr, ring, "data"),
        # a leading dim that is no multiple of the ring: padded, as in the reference
        "allreduce_ring_padded": allreduce_ring(inp["halo"][r], ring, "data"),
        "reduce_scatter": reduce_scatter(xr, ring, "data"),
        "ring_shift": ring_shift(xr, ring, "data", 1),
        "ring_shift_3": ring_shift(xr, ring, "data", 3),
        "halo_exchange": halo_exchange(inp["halo"][r], ring, "data", 2),
        "all_gather_axis": all_gather_axis(inp["xr"][r:r + 1], ring, "data", dim=0),
        "all_gather_axis_dim1": all_gather_axis(
            inp["xr"][:, w * r:w * (r + 1)], ring, "data", dim=1),
        "compressed_allreduce": compressed_allreduce(xc, main, "pod", ("data",)),
        "compressed_allreduce_slow_inner": compressed_allreduce_slow_inner(
            xc, main, "pod", ("data",)),
        "compressed_exact": compressed_allreduce(xe, main, "pod", ("data",)),
        "chunked_collective": chunked_collective(
            lambda p: allreduce_flat(p, main, dp), x, 2, axis=0),
    }
    q, s = quantize_int8(reduce_scatter(xe, main, "data"))
    out["compressed_exact_q"], out["compressed_exact_s"] = q, s
    for (o, i), mesh in a2a.items():
        blocks = inp["blocks"][r]
        oi = ("outer", "inner")
        out[f"alltoall_direct_{o}x{i}"] = alltoall_direct(blocks, mesh, oi)
        out[f"alltoall_direct_inner_{o}x{i}"] = alltoall_direct_inner(blocks, mesh, oi)
        out[f"alltoall_hierarchical_{o}x{i}"] = alltoall_hierarchical(blocks, mesh, *oi)
        out[f"alltoall_hier_inner_{o}x{i}"] = alltoall_hier_inner(blocks, mesh, *oi)
    out["alltoall_auto"] = alltoall(inp["blocks"][r], main, dp, strategy="auto")
    meta = lambda n: torch.empty(n, dtype=torch.float32, device="meta")  # noqa: E731
    out["auto_allreduce_picks"] = [auto_allreduce_strategy(meta(n), main)
                                   for n in ALLREDUCE_PICK_ELEMS]
    out["auto_alltoall_picks"] = [auto_alltoall_strategy(meta(world * n), main, dp)
                                  for n in ALLTOALL_PICK_ELEMS]
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _meshes(device: torch.device, world: int):
    """The (2, world/2) mesh the strategies reduce over, and a (1, world)
    mesh for ``ring``, which reduces over ``fast_axes[0]`` only (as in the
    reference), so that every strategy sums over the whole world."""
    return (make_mesh((2, world // 2), ("pod", "data"), device.type),
            make_mesh((1, world), ("pod", "data"), device.type))


def full_width(device: torch.device, world: int, n: int, n_chunks: int) -> dict:
    """Reduce an f32 gradient of ``n`` elements with each strategy, in
    ``n_chunks`` chunks (``chunked_collective`` along dim 0).

    Every rank draws the same g, integers in [-1024, 1024] from seed 0;
    rank r contributes (r + 1)·g, so every sum is exact in f32 whatever its
    order, and each rank's result must equal (world(world+1)/2)·g exactly.
    Returns each strategy's wall (host clock ending in a synchronise), the
    ``auto`` pick and this rank's peak memory."""
    main, ring = _meshes(device, world)
    r = dist.get_rank()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(-1024, 1025, (n,), generator=gen, dtype=torch.float32, device=device)
    x.mul_(r + 1)
    total = world * (world + 1) // 2
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    walls, exact = {}, {}
    for s in (*STRATEGIES, "auto"):
        mesh = ring if s == "ring" else main
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        out = chunked_collective(lambda p: allreduce(p, mesh, strategy=s), x, n_chunks, axis=0)
        _sync(device)
        walls[s] = time.perf_counter() - t0
        step = -(-n // n_chunks)
        exact[s] = all(torch.equal(out[a:a + step], x[a:a + step] / (r + 1) * total)
                       for a in range(0, n, step))
        del out
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"walls": walls, "exact": exact, "bytes": n * 4, "peak_bytes": peak,
            "auto": auto_allreduce_strategy(x[: -(-n // n_chunks)], main)}


def fit(device: torch.device, world: int, sizes: Sequence[int],
        autotune_sizes: Sequence[int]) -> dict:
    """Time ``flat`` and ``hierarchical`` on the (2, world/2) mesh and ``ring``
    on (1, world) at ``sizes`` bytes a rank (:func:`bench_collective`, the
    ranks agreeing on every repetition count), and ``flat`` on host tensors
    (``flat_host``: the exchange without the copies), fit α and β to each, run
    ``bench_allreduce`` at its defaults, and ``measured_autotune`` over the
    three at ``autotune_sizes`` against the model's pick for the mesh."""
    from repro_torch.comms.autotune import measured_autotune, select_allreduce_strategy
    from repro_torch.core.benchmark import bench_allreduce, bench_collective

    main, ring = _meshes(device, world)
    meshes = {s: ring if s == "ring" else main for s in STRATEGIES}

    def make(s: int) -> torch.Tensor:
        return torch.ones(max(s // 4, 1), dtype=torch.float32, device=device)

    def host(s: int) -> torch.Tensor:
        return torch.ones(max(s // 4, 1), dtype=torch.float32)

    res = {}
    runs = {s: (make, lambda buf, s=s: allreduce(buf, meshes[s], strategy=s)) for s in STRATEGIES}
    # the host exchange alone: flat on host tensors, no copy to or from the card
    runs["flat_host"] = (host, lambda buf: allreduce(buf, main, strategy="flat"))
    for s, (mk, run) in runs.items():
        b = bench_collective(mk, run, sizes)
        res[s] = {"sizes": b.sizes, "times": b.times,
                  "alpha": b.fitted.alpha, "beta": b.fitted.beta}
    flat = bench_allreduce(device=device)["allreduce_flat"]
    res["bench_allreduce"] = {"sizes": flat.sizes, "times": flat.times,
                              "alpha": flat.fitted.alpha, "beta": flat.fitted.beta}
    records = []
    for nbytes in autotune_sizes:
        buf = make(nbytes)

        def cand(s):
            def go():
                allreduce(buf, meshes[s], strategy=s)
                _sync(device)
            return go

        pick = select_allreduce_strategy({"pod": 2, "data": world // 2}, float(nbytes))
        rec = measured_autotune({s: cand(s) for s in STRATEGIES}, model_pick=pick)
        records.append({"nbytes": nbytes, "measured": rec.measured, "pick": rec.strategy,
                        "model_pick": rec.model_pick, "agreed": rec.agreed})
    res["autotune"] = records
    return res


def card_run(device: torch.device, world: int, n: int, n_chunks: int,
             sizes: Sequence[int], autotune_sizes: Sequence[int]) -> dict:
    """:func:`run_checks`, :func:`full_width` and :func:`fit` in one world."""
    return {"checks": run_checks(device, world),
            "full": full_width(device, world, n, n_chunks),
            "fit": fit(device, world, sizes, autotune_sizes)}


def identity(device: torch.device) -> Dict[str, bool]:
    """On a one-rank world every strategy and data movement returns its input."""
    mesh = make_mesh((1, 1), ("pod", "data"), device.type)
    x = torch.randn(16, 5, generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    out = {f"allreduce_{s}": allreduce(x, mesh, strategy=s)
           for s in (*STRATEGIES, "auto")}
    out["reduce_scatter"] = reduce_scatter(x, mesh, "data")
    out["alltoall_direct"] = alltoall_direct(x[:1], mesh, ("pod", "data"))
    out["alltoall_hierarchical"] = alltoall_hierarchical(x[:1], mesh, "pod", "data")
    out["ring_shift"] = ring_shift(x, mesh, "data")
    out["all_gather_axis"] = all_gather_axis(x, mesh, "data", dim=1)
    out["halo_exchange"] = halo_exchange(x, mesh, "data", 2)[2:-2]
    return {k: bool(torch.equal(v, x[:1] if k.startswith("alltoall") else x))
            for k, v in out.items()}

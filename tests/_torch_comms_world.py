"""Rank programs for ``tests/test_torch_comms_local.py``'s worlds.  They live
in a module of their own, which imports no JAX, because every spawned rank
imports the module of the function it runs."""
import time

import torch
import torch.distributed as dist

from repro_torch.comms import routes
from repro_torch.core.benchmark import bench_allreduce, bench_collective
from repro_torch.launch.mesh import (
    axes_group,
    axes_index,
    dp_axes_of,
    make_mesh,
    make_production_mesh,
    mesh_axes,
)


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def mesh_program(device):
    """The mesh helpers, their errors and the collective timers on a world of 4."""
    out = {"wrong_size": _error(lambda: make_mesh((2, 4), ("pod", "data"), device.type)),
           "production": _error(lambda: make_production_mesh(device=device.type)),
           "production_multi": _error(
               lambda: make_production_mesh(multi_pod=True, device=device.type))}
    m = make_mesh((2, 2), ("pod", "data"), device.type)
    m3 = make_mesh((1, 2, 2), ("pod", "data", "model"), device.type)
    out["axes"], out["dp"], out["dp3"] = mesh_axes(m), dp_axes_of(m), dp_axes_of(m3)
    out["order"] = _error(lambda: axes_group(m, ("data", "pod")))
    out["unknown"] = _error(lambda: axes_group(m, ("pod", "model")))
    sets = [("pod", "data"), ("data", "model"), ("pod", "model"), ("pod", "data", "model")]
    out["index"] = {"/".join(s): axes_index(m3, s) for s in sets}
    out["group_size"] = {"/".join(s): dist.get_world_size(axes_group(m3, s)) for s in sets}
    out["bench"] = {k: (v.sizes, v.times) for k, v in
                    bench_allreduce(sizes=(1 << 12, 1 << 16), device=device).items()}
    # ranks whose first calls differ a lot in time still agree on the counts
    calls = [0]
    rank = dist.get_rank()

    def skewed(buf):
        calls[0] += 1
        time.sleep(0.004 * rank if calls[0] % 7 == 1 else 0.0)
        routes.all_reduce(buf, dist.group.WORLD)

    bench_collective(lambda s: torch.zeros(s // 4), skewed, (1 << 10, 1 << 12))
    out["calls"] = calls[0]
    return out


def raise_on_rank_1(device):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # never returns: rank 1 does not reach it


def sleep_forever(device):
    time.sleep(3600)

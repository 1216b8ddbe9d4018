"""Meshes over a ``torch.distributed`` world, and a helper that starts a world.

Ported from ``repro.launch.mesh``.  The reference's mesh is ``jax.make_mesh``
over the devices of one process.  Here each rank is a process, and a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names`` over
the initialised world: rank r sits at the row-major coordinate of r, the
slot the reference's global array gives device r.  One axis's group is
``mesh.get_group(name)``; a set of several axes (``("pod", "data")``) needs
one group for the whole set, so :func:`make_mesh` builds every such set of
the mesh once, in one order on every rank (``dist.new_group`` is collective
over the whole world), and :func:`axes_group` looks it up.

:func:`run_world` starts a world of N processes (the ``spawn`` start method,
a file store in a temporary directory) and runs one function on every rank,
each on its own device: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import itertools
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

# DeviceMesh attribute holding the groups of the mesh's multi-axis sets
_SET_GROUPS = "_repro_set_groups"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the whole initialised world.

    Raises, as ``jax.make_mesh`` does, when the world's size differs from the
    product of ``shape``.  ``device`` is the mesh's device type (``"cuda"`` or
    ``"cpu"``), where the tensors its collectives move lie."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised (see run_world)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_mesh: the world has {world} ranks, the mesh shape {shape} "
                         f"needs {math.prod(shape)}")
    mesh = DeviceMesh(device, torch.arange(world).reshape(shape), mesh_dim_names=axes)
    groups: Dict[Tuple[str, ...], Any] = {}
    coords = np.arange(world).reshape(shape)
    for n in range(2, len(axes) + 1):
        for dims in itertools.combinations(range(len(axes)), n):
            rest = [d for d in range(len(axes)) if d not in dims]
            # one group per coordinate of the other axes, its ranks in the
            # set's row-major order (new_group sorts them, which is the same)
            sets = np.moveaxis(coords, rest + list(dims), range(len(axes)))
            sets = sets.reshape(-1, math.prod(shape[d] for d in dims))
            mine = None
            for ranks in sets.tolist():
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    mine = g
            groups[tuple(axes[d] for d in dims)] = mine
    setattr(mesh, _SET_GROUPS, groups)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """The reference's production meshes: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")``; raises on a smaller world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_dims(arg: str, world: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The shape and axis names the reference's ``build_mesh`` gives
    ``--mesh-shape`` ``arg`` ("4,2" => data=4, model=2; three numbers add
    "pod" in front), or, for an empty ``arg``, a world of ``world``
    devices: (1, 1) for one, (n/2, 2) for an even n, else (n, 1)."""
    if arg:
        dims = tuple(int(x) for x in arg.split(","))
    else:
        n = world
        dims = (max(n // 1, 1), 1) if n == 1 else (n // 2, 2) if n % 2 == 0 else (n, 1)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"--mesh-shape {arg!r}: one to three positive sizes, "
                         "for (pod,) data, model")
    return dims, ("pod", "data", "model")[-len(dims):]


def build_mesh(arg: str, device: str = "cuda") -> DeviceMesh:
    """The reference's ``build_mesh`` (``repro.launch.train``) over the
    initialised world: :func:`mesh_dims` of ``arg`` and the world's size."""
    dims, names = mesh_dims(arg, dist.get_world_size())
    return make_mesh(dims, names, device)


def mesh_axes(mesh: DeviceMesh) -> dict:
    """Axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axes_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of ``axes`` (one name, or several in the mesh's
    order); a rank's index in it is its row-major coordinate over ``axes``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    unknown = [a for a in axes if a not in names]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes}: not distinct axes of the mesh {names}")
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} must be given in the mesh's order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return getattr(mesh, _SET_GROUPS)[axes]


def axes_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major coordinate over ``axes``."""
    return dist.get_rank(axes_group(mesh, axes))


# --------------------------------------------------------------------------
# A world of processes.
# --------------------------------------------------------------------------

def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(rank: int, world_size: int, store: str, backend: str, device_type: str,
               timeout: float, fn: Callable, args: tuple, results) -> None:
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout))
        out = _to_host(fn(device, *args))
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which kills the world
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))


def _kill(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(timeout=10)


def run_world(fn: Callable, world_size: int, *args, device: str = "cuda",
              backend: str = "gloo", timeout: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` on every rank of a new world of
    ``world_size`` processes and return the ranks' results in rank order
    (tensors come back as numpy arrays).

    ``fn`` must be importable by name (a module-level function of a package:
    a ``spawn`` child imports it anew).  ``device`` is ``"cuda"`` (rank r on
    card r mod the count) or ``"cpu"``; ``backend`` is ``"gloo"`` or
    ``"nccl"``.  When any rank raises, when a rank dies, or when ``timeout``
    seconds pass before every rank has returned, every child is killed and
    this raises with the rank's traceback; it never returns a partial result."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_world: device 'cuda' asked for but no CUDA GPU is visible; "
                           "pass device='cpu' to run the world on the host")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_world_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, os.path.join(tmp, "store"), backend, device,
                               timeout, fn, args, results))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got: Dict[int, Any] = {}
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"run_world: ranks {missing} of {world_size} did not finish "
                                   f"{getattr(fn, '__name__', fn)} within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    try:  # a rank's report may still be in the pipe
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(f"run_world: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} without a result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"run_world: rank {rank} of {world_size} raised:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=30)
        return [got[r] for r in range(world_size)]
    finally:
        _kill(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# a served or trained world's whole run, start to end: at full width its
# gathers and all-to-alls through the host take seconds a step
ENTRY_TIMEOUT = 3600.0


def run_entry_world(fn: Callable, world_size: int, *args, device: str) -> List[Any]:
    """``run_world`` for the entry points' ``--mesh-shape``: gloo when the
    machine has fewer cards than ranks (several ranks then share a card) or
    on the CPU, NCCL when each rank has its own card."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; pass --device cpu")
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= world_size else "gloo"
    return run_world(fn, world_size, *args, device=device, backend=backend,
                     timeout=ENTRY_TIMEOUT)

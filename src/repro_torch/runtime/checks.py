"""Elastic re-scale across worlds, driven as one rank's program for
``repro_torch.launch.mesh.run_world``: the port's counterpart of the
reference's ``elastic_reshard``, ``elastic_shrink_continuity`` and
``elastic_grow_continuity`` checks (``tests/_multidevice_checks.py``).

:func:`leg_program` runs a list of legs in one world.  A leg builds a
(data, model) mesh over the world, takes its weights and AdamW state (this
rank's blocks of a whole tree it is given or draws from a seed, the state
the leg before it left on the same mesh, or a checkpoint restored onto the
new mesh with ``Checkpointer.restore(..., shardings=...)``), runs sharded
``train_step``s on given token batches or on ``data.SyntheticLM``'s, and
may save the gathered ``{"params", "opt"}`` blob (rank 0 writes, then a
barrier), save the parameters alone, hold its blocks against another
checkpoint's, or return them.  The same program runs the CPU tests at
smoke width and ``chip_smoke.py``'s re-scale at full width; a world of
another size is another ``run_world`` call, with a checkpoint as the
hand-off.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

AXES = ("data", "model")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batches(leg: dict):
    """The leg's whole token batches, one a step: given ones, or
    ``SyntheticLM``'s for steps [start, stop) of ``synthetic``'s seed, or
    none."""
    if "tokens" in leg:
        return list(leg["tokens"])
    if "synthetic" not in leg:
        return []
    from repro_torch.data import SyntheticLM

    seed, start, stop = leg["synthetic"]
    cfg, run = leg["cfg"], leg["run"]
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=run.seq_len,
                       global_batch=run.global_batch, seed=seed)
    return [torch.from_numpy(data.batch(s)["tokens"]) for s in range(start, stop)]


def _npz_leaf(npz: str, name: str) -> np.ndarray:
    """Leaf ``name`` of an uncompressed npz, mapped from the file at its
    member's offset: a read apart from ``np.load``'s (the restore's), and
    no CRC pass over the bytes."""
    import struct
    import zipfile

    with zipfile.ZipFile(npz) as z:
        info = z.getinfo(f"{name}.npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{npz}: member {name} is compressed")
    with open(npz, "rb") as f:
        f.seek(info.header_offset + 26)  # the local header's name and extra lengths
        n_name, n_extra = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if not shape:
            return np.frombuffer(f.read(dtype.itemsize), dtype).reshape(())
        offset = f.tell()
    return np.memmap(npz, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


def _check_restored(path: str, step: int, blob: dict, shardings: dict) -> int:
    """Every restored block equal, bit for bit, to ``reshard_tree`` of the
    leaf mapped whole from the checkpoint's npz, one leaf at a time; returns
    how many leaves were held."""
    import json
    import os

    from repro_torch.checkpoint.checkpointer import _flatten_with_names, _from_host
    from repro_torch.models.convert import tree_leaves
    from repro_torch.runtime.elastic import reshard_tree

    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    dtypes = dict(zip(meta["names"], meta["dtypes"]))
    named = _flatten_with_names(blob)
    sh = tree_leaves(shardings)
    npz = os.path.join(d, "arrays.npz")
    for (name, block), s in zip(named, sh):
        whole = _from_host(_npz_leaf(npz, name), dtypes[name])
        (want,) = reshard_tree([whole], [s])
        if not torch.equal(block.cpu(), want):
            raise AssertionError(f"restored block of {name} differs from the checkpoint's")
    return len(named)


def _leg(device: torch.device, leg: dict, state: Optional[tuple]) -> tuple:
    import torch.distributed as tdist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import tree_leaves, tree_map, tree_map2
    from repro_torch.models.steps import train_step
    from repro_torch.models.transformer import DistContext, batch_slot, init_params, param_shapes
    from repro_torch.optim import init_state
    from repro_torch.sharding.specs import gather_to_host, opt_shardings, param_shardings

    cfg, run = leg["cfg"], leg["run"]
    mesh = make_mesh(leg["mesh"], AXES, device.type)
    dist = DistContext(mesh=mesh, dp_axes=("data",))
    shapes = param_shapes(cfg)
    p_sh, o_sh = param_shardings(shapes, mesh), opt_shardings(shapes, mesh)
    rank0 = tdist.get_rank() == 0
    out = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if "restore" in leg:
        path, step = leg["restore"]
        _sync(device)
        t0 = time.perf_counter()
        blob = Checkpointer(path).restore(step, {"params": shapes, "opt": init_state(shapes)},
                                          shardings={"params": p_sh, "opt": o_sh},
                                          device=device)
        _sync(device)
        out["restore_seconds"] = time.perf_counter() - t0
        params, opt = blob["params"], blob["opt"]
        if leg.get("check"):
            t0 = time.perf_counter()
            out["leaves_checked"] = _check_restored(path, step, blob, {"params": p_sh, "opt": o_sh})
            out["check_seconds"] = time.perf_counter() - t0
    elif "params" in leg or "seed" in leg:
        whole = leg.get("params")
        if whole is None:
            whole = init_params(cfg, torch.Generator(device=device).manual_seed(leg["seed"]))
        params = tree_map2(lambda s, t: s.shard(t.to(device)), p_sh, whole)
        del whole
        opt = init_state(params)
    else:  # the state the leg before left, on the same layout
        params, opt = state
    metrics, walls = [], []
    for toks in _batches(leg):
        t0 = time.perf_counter()
        params, opt, m = train_step(cfg, run, params, opt,
                                    {"tokens": batch_slot(dist, toks.to(device))},
                                    dist=dist, shardings=p_sh)
        metrics.append({k: float(v) for k, v in m.items()})  # waits for the device
        walls.append(time.perf_counter() - t0)
    out["metrics"], out["walls"] = metrics, walls
    for key, tree in (("save", lambda: {"params": params, "opt": opt}),
                      ("save_params", lambda: params)):
        if key not in leg:
            continue
        path, step = leg[key]
        t0 = time.perf_counter()
        whole = gather_to_host({"params": p_sh, "opt": o_sh} if key == "save" else p_sh,
                               tree(), keep=rank0)
        if rank0:
            Checkpointer(path, keep=leg.get("keep", 3)).save(step, whole, block=True)
        del whole
        tdist.barrier()  # the files are complete before any rank reads them
        out[f"{key}_seconds"] = time.perf_counter() - t0
    if "compare" in leg:  # the largest distance of a parameter from another run's
        path, step = leg["compare"]
        ref = Checkpointer(path).restore(step, shapes, shardings=p_sh, device=device)
        out["max_param_distance"] = max(
            float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
            for a, b in zip(tree_leaves(params), tree_leaves(ref)))
    if leg.get("blocks"):
        host = lambda t: t.detach().float().cpu()  # noqa: E731
        out["blocks"] = {"params": tree_map(host, params), "mu": tree_map(host, opt.mu),
                         "nu": tree_map(host, opt.nu), "step": int(opt.step)}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return out, (params, opt)


def leg_program(device: torch.device, legs: List[dict]) -> List[dict]:
    """Run ``legs`` in order on this rank (see the module docstring); one
    result a leg: each step's metrics and wall, and where asked the
    restore's seconds, the leaves it held bit for bit and the check's
    seconds, the saves' seconds, the largest parameter distance from another checkpoint, the
    rank's blocks (f32, on the host), and the leg's peak device memory."""
    state, out = None, []
    for leg in legs:
        res, state = _leg(device, leg, state)
        out.append(res)
    return out

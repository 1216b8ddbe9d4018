"""npz checkpointing with async writes, in the JAX package's on-disk format.

Ported from ``repro.checkpoint.checkpointer``; a checkpoint either package
writes restores in the other.  Layout::

    <dir>/step_<N>/
        meta.json     — step, flat name list, dtypes, shapes
        arrays.npz    — one entry per leaf, named by its path
        .complete     — commit marker (the directory is renamed into place last)

A leaf's name is its path as JAX's ``tree_flatten_with_path`` spells it:
dict keys in sorted order, sequence indices, NamedTuple field names, joined
by ``/`` (``params/embed/tok``, ``opt/step``, ``opt/mu/groups/0/1/...``).
npz cannot hold bfloat16, so a bf16 leaf is stored as its bits in
``uint16`` with ``"bfloat16"`` in ``meta.json``; the bits are taken with
``Tensor.view(torch.int16)``, so no ``ml_dtypes`` is needed.

Properties the tests assert: save -> restore is bitwise identical;
interrupted writes (no ``.complete``) are ignored by ``latest_step``; with
``block=False`` the device -> host copy is made at once (a consistent
snapshot) and file I/O runs on a background thread.

Leaves are stored whole, so a checkpoint restores on any mesh
(reshard-on-restore, the elastic re-scale path): ``restore(step, like,
shardings=...)`` reads one leaf at a time and keeps only this rank's block
of it (``Sharding.shard``), with no collective.  ``like`` may be a tree of
meta tensors (``param_shapes``); its leaves then go to ``device``.  Each
stored leaf's shape must be ``like``'s, or ``restore`` raises naming it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import tree_leaves, tree_unflatten


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple: field names
        return [x for k, v in zip(tree._fields, tree)
                for x in _flatten_with_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_names(v, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _to_host(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(dtype name as numpy spells it, a host copy); bf16 as its uint16
    bits.  Always a copy: a CPU tensor's ``numpy()`` shares its storage,
    which the next training step overwrites in place while an async write
    is still reading it."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return str(a.dtype), a


def _from_host(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A tensor over ``a``'s buffer, no copy (the caller copies: an npz
    member is read into a read-only buffer)."""
    a = np.require(a, requirements="C")  # ascontiguousarray makes a 0-d leaf 1-d
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        if dtype_name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any, block: bool = True) -> None:
        """Serialize ``tree`` at ``step``.  With block=False the device->host
        copy happens synchronously (consistent snapshot) but file I/O runs on
        a background thread."""
        host = []
        dtypes = []
        for n, leaf in _flatten_with_names(tree):
            dt, a = _to_host(leaf)
            dtypes.append(dt)
            host.append((n, a))

        def write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **dict(host))
            meta = {
                "step": step,
                "names": [n for n, _ in host],
                "shapes": [list(a.shape) for _, a in host],
                "dtypes": dtypes,
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            open(os.path.join(tmp, ".complete"), "w").close()
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self.wait()
        if block:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for d in sorted(os.listdir(self.directory)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, ".complete")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None, device=None,
                coord: Optional[Mapping[str, int]] = None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors), each
        leaf a new tensor in the dtype of ``like``'s leaf, on its device, or
        on ``device`` where ``like``'s leaf is on the meta device.

        ``shardings`` (a tree of ``sharding.specs.Sharding`` of ``like``'s
        structure) keeps only this rank's block of each leaf, by the rank's
        coordinates on the sharding's mesh or by ``coord``: the leaves are
        read one at a time and no collective runs.  A stored leaf whose
        shape differs from ``like``'s raises a ``ValueError`` naming it."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        dtypes = dict(zip(meta["names"], meta["dtypes"]))
        named = _flatten_with_names(like)
        blocks = [None] * len(named) if shardings is None else tree_leaves(shardings)
        if len(blocks) != len(named):
            raise ValueError(f"restore: {len(blocks)} shardings for {len(named)} leaves")
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for (name, leaf), sharding in zip(named, blocks):
                a = data[name]
                if tuple(a.shape) != tuple(leaf.shape):
                    raise ValueError(f"restore: leaf {name!r} of step {step} has shape "
                                     f"{tuple(a.shape)}, the tree to fill {tuple(leaf.shape)}")
                if leaf.device.type == "meta":
                    if device is None:
                        raise ValueError(f"restore: leaf {name!r} is on the meta device "
                                         "and no device was given")
                    where = device
                else:
                    where = leaf.device
                t = _from_host(a, dtypes.get(name))
                if sharding is not None:
                    t = sharding.shard(t, coord)  # a new tensor of the block alone
                leaves.append(t.to(device=where, dtype=leaf.dtype, copy=sharding is None))
                del a, t
        return tree_unflatten(like, leaves)

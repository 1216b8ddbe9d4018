"""Training entry point, on one device or across the ranks of a mesh.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 20
    python -m repro_torch.launch.train --smoke --device cpu --steps 20 --batch 8 --seq 64
    python -m repro_torch.launch.train --smoke --device cpu --mesh-shape 2,2 --steps 3

Ported from ``repro.launch.train``: the same flags (plus ``--device``, which
defaults to ``cuda``), the same synthetic token stream from ``--seed``
(``data.SyntheticLM``, numpy, bit for bit the JAX package's), the same
loop: a batch to the device, ``train_step``, the ``[train] step ...`` line,
a checkpoint every ``--checkpoint-every`` steps in the JAX package's format,
resume from the latest complete one, and the straggler monitor.  ``main``
parses the flags and calls ``run``, which trains a config it is given.
Weights are drawn from a ``torch.Generator`` seeded with ``--seed``, so
they differ from the JAX package's (``run`` also takes given ones).  The
kernels stay off, as the reference trains with ``use_pallas`` off: they
have no backward.

``--mesh-shape`` of more than one device trains across that many ranks,
each a process: ``launch.mesh.run_world`` starts them (gloo when the
machine has fewer cards than ranks, several ranks then sharing a card;
NCCL when each rank has its own card; gloo on the CPU), or, inside a world
already initialised (torchrun), the mesh is built over it.  As in the
reference: ``tp_adapt`` for the model axis, a ``DistContext``, the weights
and AdamW moments sharded by ``param_shardings`` and ``opt_shardings``, the
batch's slot over the data axes, and the sharded ``train_step``.  Rank 0
prints the lines.  A checkpoint of a world is the gathered tree, written
by rank 0 in the reference's format, the same files a one-device run
writes.  A resume reads it on every rank, one leaf at a time, and keeps the
rank's blocks (``Checkpointer.restore(..., shardings=...)``, no
collective), so a checkpoint written on one mesh resumes on another, or on
one device, whose axes divide its shapes.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.kernels.config import DEFAULT_DEVICE
from repro_torch.launch.mesh import build_mesh, dp_axes_of, mesh_dims, run_entry_world
from repro_torch.models.convert import tree_map2
from repro_torch.models.moe import check_ep_layout
from repro_torch.models.steps import train_step
from repro_torch.models.transformer import DistContext, batch_slot, init_params, param_shapes
from repro_torch.optim import adamw
from repro_torch.runtime import StragglerMonitor
from repro_torch.sharding import specs


def main(argv=None) -> float:
    """The command line: train ``--arch``'s published config, or its smoke
    config with ``--smoke``; returns the last step's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="schedule horizon (defaults to --steps); set it when "
                         "running a partial leg of a longer run")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh-shape", default="", help="e.g. 4,2 => data=4,model=2")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    in_world = tdist.is_initialized()
    dims, names = mesh_dims(args.mesh_shape, tdist.get_world_size() if in_world else 1)
    world = math.prod(dims)
    cfg0 = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg, ep_shards = specs.tp_adapt(cfg0, dict(zip(names, dims)).get("model", 1))
    if world > 1 and cfg.is_moe:  # before any collective
        check_ep_layout(cfg, dict(zip(names, dims))["model"], ep_shards)
    run_cfg = RunConfig(
        model=cfg,
        seq_len=args.seq,
        global_batch=args.batch,
        n_microbatches=args.microbatches,
        learning_rate=args.lr,
        warmup_steps=args.warmup,
        total_steps=args.total_steps or args.steps,
    )
    kw = dict(seed=args.seed, steps=args.steps, checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every, log_every=args.log_every)
    if world == 1:
        losses, _ = run(cfg, run_cfg, device=args.device, **kw)
    elif in_world:
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", tdist.get_rank() % torch.cuda.device_count())
        losses, _ = world_run(device, cfg, run_cfg, args.mesh_shape, ep_shards, kw)
    else:
        losses, _ = run_entry_world(world_run, world, cfg, run_cfg, args.mesh_shape, ep_shards,
                                    kw, device=torch.device(args.device).type)[0]
    return losses[-1]


def world_run(device: torch.device, cfg: ModelConfig, run_cfg: RunConfig, mesh_shape: str,
              ep_shards: int, kw: dict) -> Tuple[List[float], List[float]]:
    """One rank's training: the mesh of ``mesh_shape`` over the world, its
    ``DistContext``, then ``run``."""
    mesh = build_mesh(mesh_shape, device.type)
    dist = DistContext(mesh=mesh, dp_axes=dp_axes_of(mesh) or ("data",), ep_shards=ep_shards)
    return run(cfg, run_cfg, device=device, dist=dist, **kw)


def run(cfg: ModelConfig, run_cfg: RunConfig, *, seed: int, steps: int, device,
        params: Optional[dict] = None, opt_state: Optional[adamw.AdamWState] = None,
        checkpoint_dir: str = "", checkpoint_every: int = 50,
        log_every: int = 1,
        dist: Optional[DistContext] = None) -> Tuple[List[float], List[float]]:
    """Train ``cfg`` from step 0 (or the latest checkpoint in
    ``checkpoint_dir``) up to ``steps`` on batches of ``run_cfg.global_batch``
    x ``run_cfg.seq_len`` tokens from ``seed``.  ``params`` and
    ``opt_state`` default to random weights from ``seed`` and a fresh AdamW
    state; given ones are updated in place (the state's step count too),
    unless a checkpoint replaces them.  Returns the loss and the wall time
    in seconds of each step run: a batch to the device, ``train_step`` and
    the loss read back, the time the straggler monitor classifies.

    With ``dist`` this is one rank's run: ``params`` and ``opt_state`` are
    its blocks (by default the blocks of the whole draw from ``seed``), each
    step trains on its slot of the batch, and only rank 0 prints."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; pass --device cpu")

    shardings = None
    if dist is not None:
        shardings = specs.param_shardings(param_shapes(cfg, dist.ep_shards), dist.mesh)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                             ep_shards=1 if dist is None else dist.ep_shards)
        if dist is not None:
            params = tree_map2(lambda s, t: s.shard(t), shardings, params)
    opt = adamw.init_state(params) if opt_state is None else opt_state
    log = dist is None or tdist.get_rank() == 0
    data = SyntheticLM(
        vocab_size=cfg.vocab_size,
        seq_len=run_cfg.seq_len,
        global_batch=run_cfg.global_batch,
        seed=seed,
        frontend_tokens=cfg.frontend_tokens,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend_tokens else 0,
    )

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    opt_sh = None if dist is None else adamw.AdamWState(
        step=specs.Sharding(dist.mesh, specs.P()), mu=shardings, nu=shardings)

    def save(step: int, block: bool) -> None:
        tree = {"params": params, "opt": opt}
        if dist is not None:  # collective: every rank gathers, rank 0 writes
            tree = specs.gather_to_host({"params": shardings, "opt": opt_sh}, tree, keep=log)
        if log:
            ckpt.save(step, tree, block=block)

    start = 0
    if ckpt and dist is not None:
        ckpt.wait()  # rank 0's write lands before any rank looks for it
        tdist.barrier()
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        shapes = param_shapes(cfg, 1 if dist is None else dist.ep_shards)
        like = {"params": shapes, "opt": adamw.init_state(shapes)}
        blocks = None if dist is None else {"params": shardings, "opt": opt_sh}
        blob = ckpt.restore(start, like, shardings=blocks, device=device)
        params, opt = blob["params"], blob["opt"]
        if log:
            print(f"[train] resumed from step {start}")

    mon = StragglerMonitor()
    tokens_per_step = run_cfg.global_batch * run_cfg.seq_len
    losses, walls = [], []
    for step in range(start, steps):
        t0 = time.perf_counter()
        batch = {k: batch_slot(dist, torch.from_numpy(v).to(device))
                 for k, v in data.batch(step).items()}
        params, opt, metrics = train_step(cfg, run_cfg, params, opt, batch, dist=dist,
                                          shardings=shardings)
        loss = float(metrics["loss"])  # waits for the device
        dt = time.perf_counter() - t0
        losses.append(loss)
        walls.append(dt)
        mon.record(step, dt)
        if log and step % log_every == 0:
            print(
                f"[train] step {step} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"{tokens_per_step / dt:.0f} tok/s",
                flush=True,
            )
        if ckpt and (step + 1) % checkpoint_every == 0:
            save(step + 1, block=False)
        if log and mon.should_mitigate:
            print("[train] straggler mitigation advised (persistent slow steps)")
    if ckpt:
        save(steps, block=True)
    if log and losses:
        print(f"[train] done: final loss {losses[-1]:.4f}", flush=True)
    return losses, walls



if __name__ == "__main__":
    main()

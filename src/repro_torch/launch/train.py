"""Training entry point on one device.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 20
    python -m repro_torch.launch.train --smoke --device cpu --steps 20 --batch 8 --seq 64

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
have no backward.  One device only: a ``--mesh-shape`` of more than one
device is refused until distribution is ported.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.kernels.config import DEFAULT_DEVICE
from repro_torch.models.steps import train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw
from repro_torch.runtime import StragglerMonitor


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
    if args.mesh_shape and math.prod(int(x) for x in args.mesh_shape.split(",")) > 1:
        ap.error(f"--mesh-shape {args.mesh_shape}: the port trains on one device; "
                 "distribution is ROADMAP.md Queue 1 item 7")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run_cfg = RunConfig(
        model=cfg,
        seq_len=args.seq,
        global_batch=args.batch,
        n_microbatches=args.microbatches,
        learning_rate=args.lr,
        warmup_steps=args.warmup,
        total_steps=args.total_steps or args.steps,
    )
    losses, _ = run(cfg, run_cfg, seed=args.seed, steps=args.steps, device=args.device,
                 checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
                 log_every=args.log_every)
    return losses[-1]


def run(cfg: ModelConfig, run_cfg: RunConfig, *, seed: int, steps: int, device,
        params: Optional[dict] = None, opt_state: Optional[adamw.AdamWState] = None,
        checkpoint_dir: str = "", checkpoint_every: int = 50,
        log_every: int = 1) -> Tuple[List[float], List[float]]:
    """Train ``cfg`` from step 0 (or the latest checkpoint in
    ``checkpoint_dir``) up to ``steps`` on batches of ``run_cfg.global_batch``
    x ``run_cfg.seq_len`` tokens from ``seed``.  ``params`` and
    ``opt_state`` default to random weights from ``seed`` and a fresh AdamW
    state; given ones are updated in place (the state's step count too),
    unless a checkpoint replaces them.  Returns the loss and the wall time
    in seconds of each step run: a batch to the device, ``train_step`` and
    the loss read back, the time the straggler monitor classifies."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; pass --device cpu")

    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    opt = adamw.init_state(params) if opt_state is None else opt_state
    data = SyntheticLM(
        vocab_size=cfg.vocab_size,
        seq_len=run_cfg.seq_len,
        global_batch=run_cfg.global_batch,
        seed=seed,
        frontend_tokens=cfg.frontend_tokens,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend_tokens else 0,
    )

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        blob = ckpt.restore(start, {"params": params, "opt": opt})
        params, opt = blob["params"], blob["opt"]
        print(f"[train] resumed from step {start}")

    mon = StragglerMonitor()
    tokens_per_step = run_cfg.global_batch * run_cfg.seq_len
    losses, walls = [], []
    for step in range(start, steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
        params, opt, metrics = train_step(cfg, run_cfg, params, opt, batch)
        loss = float(metrics["loss"])  # waits for the device
        dt = time.perf_counter() - t0
        losses.append(loss)
        walls.append(dt)
        mon.record(step, dt)
        if step % log_every == 0:
            print(
                f"[train] step {step} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"{tokens_per_step / dt:.0f} tok/s",
                flush=True,
            )
        if ckpt and (step + 1) % checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt}, block=False)
        if mon.should_mitigate:
            print("[train] straggler mitigation advised (persistent slow steps)")
    if ckpt:
        ckpt.save(steps, {"params": params, "opt": opt}, block=True)
    if losses:
        print(f"[train] done: final loss {losses[-1]:.4f}")
    return losses, walls


if __name__ == "__main__":
    main()

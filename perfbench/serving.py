"""The closed loop that drives the port's serving path: one client sends
batches back to back, each a new set of prompts from the seed.

Each batch makes the calls ``repro_torch.launch.serve.run`` makes, in its
order, kernels on: ``models.decode.prefill``; a ``DecodeGraph`` over its
caches fed prefill's greedy pick; ``new_tokens`` steps, each preceded by
the planner's consult (``comms.autotune.select_allreduce_strategy`` on the
one-device plan shape with ``run``'s payload).  ``run`` itself draws its
weights on every call, so the window cannot drive it.

Tokens reach the host as a streaming server would send them: the first
(prefill's pick) before step 0, and the token of step i after step i + 1
has been enqueued, through a pinned buffer and an event, so that the read
never holds back the next replay.  Each token's arrival is the host clock
when its read returns.  A batch's tokens are the ``new_tokens`` that ``run``
returns: prefill's pick and those of the first ``new_tokens - 1`` steps; the
last step's pick, which ``run`` also computes and drops, is not read.

With ``instrument`` the loop also records CUDA events around every replay
and names its phases for the profiler (``torch.profiler.record_function``).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from perfbench.weights import sub_seed

# host phases of a batch, as the traced run names them
PHASES = ("prefill", "decode.graph", "decode.step0", "plan", "decode.replay", "readback.wait")


@dataclasses.dataclass
class Batch:
    """One served batch."""

    index: int
    start: float  # host clock at the prefill call
    end: float = 0.0  # host clock when its last token reached the host
    arrivals: Optional[np.ndarray] = None  # (new_tokens,) host clock of each token
    tokens: Optional[np.ndarray] = None  # (batch, new_tokens) the served ids
    first_step_s: float = 0.0  # DecodeGraph.first_step_seconds: step 0 and the capture
    capture_s: float = 0.0  # DecodeGraph.capture_seconds
    plan_s: List[float] = dataclasses.field(default_factory=list)  # each consult
    replay_ms: List[float] = dataclasses.field(default_factory=list)  # instrumented only


def prompts(traffic: dict, model: dict, seed: int, index: int, device) -> torch.Tensor:
    """Batch ``index``'s prompts (batch, prompt_len) int32: ids uniform in
    [2, vocab_size), as ``launch.serve.run`` draws them, from the seed."""
    if traffic.get("prompt_ids", "uniform") != "uniform":
        raise NotImplementedError(f"prompt_ids {traffic['prompt_ids']}")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "prompts", index))
    return torch.randint(2, model["vocab_size"], (traffic["batch"], traffic["prompt_len"]),
                         generator=gen, dtype=torch.int32, device=device)


class Server:
    """The port's serving path over given weights."""

    def __init__(self, cfg, params: dict, traffic: dict, model: dict, seed: int, device):
        from repro_torch.comms.autotune import select_allreduce_strategy
        from repro_torch.kernels.config import use_kernels
        from repro_torch.launch.serve import PLAN_SHAPE
        from repro_torch.models import decode

        if traffic.get("loop") != "closed_batches" or traffic.get("decoding") != "greedy":
            raise NotImplementedError(f"traffic {traffic.get('loop')}/{traffic.get('decoding')}")
        self.cfg, self.params, self.traffic, self.model = cfg, params, traffic, model
        self.seed, self.device = seed, torch.device(device)
        self.decode, self.consult, self.plan_shape = decode, select_allreduce_strategy, PLAN_SHAPE
        use_kernels(True)  # as serve.run serves

    def batch(self, index: int, instrument: bool = False, steps: int = 0) -> Batch:
        """Serve batch ``index`` to its last token; the last step may still
        be running on the device when this returns.  ``steps`` (set-up's
        warm batch) stops after that many decode steps: the caches keep the
        traffic's capacity, so every shape and the capture are the timed
        batches' own."""
        t = self.traffic
        B, P, cap = t["batch"], t["prompt_len"], t["prompt_len"] + t["new_tokens"]
        N = steps or t["new_tokens"]
        cuda = self.device.type == "cuda"
        tokens = prompts(t, self.model, self.seed, index, self.device)
        phase = _phases(instrument and cuda)
        host = torch.empty((N, B), dtype=torch.int64, pin_memory=cuda)
        copied = [torch.cuda.Event() if cuda else None for _ in range(N)]
        arrivals = np.zeros(N)
        rec = Batch(index, time.perf_counter())
        with phase("prefill"):
            logits, caches = self.decode.prefill(self.cfg, self.params, tokens, capacity=cap)
            first = logits.argmax(dim=-1)[:, None]
            _read(host[0], first[:, 0], copied[0])
        with phase("decode.graph"):
            graph = self.decode.DecodeGraph(self.cfg, self.params, caches, first, P, N)
            del caches, logits
        with phase("readback.wait"):
            _wait(copied[0])
        arrivals[0] = time.perf_counter()
        token_bytes = float(B * self.cfg.d_model) * 2  # serve.run's payload per token
        timer = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(N)] if instrument and cuda else None
        for i in range(N):
            with phase("plan"):
                c0 = time.perf_counter()
                self.consult(self.plan_shape, token_bytes * (P + i + 1))
                rec.plan_s.append(time.perf_counter() - c0)
            with phase("decode.step0" if i == 0 else "decode.replay"):
                if timer is not None and i:
                    timer[i][0].record()
                graph.step()
                if timer is not None and i:
                    timer[i][1].record()
                if i + 1 < N:
                    _read(host[i + 1], graph.token[:, 0], copied[i + 1])
            if i:
                with phase("readback.wait"):
                    _wait(copied[i])
                arrivals[i] = time.perf_counter()
        rec.end = arrivals[-1]
        rec.arrivals = arrivals
        rec.tokens = host.T.numpy().copy()
        rec.first_step_s, rec.capture_s = graph.first_step_seconds, graph.capture_seconds
        if timer is not None:
            timer[-1][1].synchronize()
            rec.replay_ms = [a.elapsed_time(b) for a, b in timer[1:]]
        return rec

    def window(self, seconds: float, first_index: int, instrument: bool = False) -> List[Batch]:
        """Batches back to back from ``first_index`` until ``seconds`` have
        passed since the first one's start; the batch in flight is
        finished.  Ends with the device idle."""
        done = [self.batch(first_index, instrument)]
        while time.perf_counter() - done[0].start < seconds:
            done.append(self.batch(first_index + len(done), instrument))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return done


def _read(dst: torch.Tensor, src: torch.Tensor, event) -> None:
    """Copy ``src`` into the host buffer ``dst`` behind the work queued so
    far, and mark its end with ``event``."""
    dst.copy_(src, non_blocking=event is not None)
    if event is not None:
        event.record()


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


def _phases(on: bool):
    """A context manager factory naming a host phase for the profiler."""
    if not on:
        return lambda name: nullcontext()
    from torch.profiler import record_function

    return record_function

"""How each collective reaches its backend: the route table.

The wrappers of ``repro_torch.comms`` call the five primitives below on a
process group.  Each picks its route from :data:`ROUTES`, keyed by
(backend, device type, operation), by lookup and never by catching an error:

* ``direct`` — the backend takes the tensor where it lies.  NCCL moves CUDA
  tensors on the device.  gloo moves CPU tensors over its TCP pairs; for the
  operations it takes on CUDA tensors it copies them through host memory
  itself.
* ``staged`` — this module copies the CUDA tensor into a pinned host
  buffer, runs the operation there on the host, and copies the result back
  to the card: the paper's 3-step path (device -> host, host to host,
  host -> device).

NCCL refuses two ranks on one device, so a world of several ranks on one
card runs gloo and every message crosses the host, staged either way.  The
host-to-host hop between the processes of one machine is loopback TCP, not
a network tier.  A key the table lacks raises.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

OPS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all", "send_recv")

# gloo takes CUDA tensors in its collectives but not in send/recv (which
# read the device pointer from the host: probed with torch 2.11 on an H100)
ROUTES: Dict[Tuple[str, str, str], str] = {
    **{("gloo", "cpu", op): "direct" for op in OPS},
    **{("nccl", "cuda", op): "direct" for op in OPS},
    **{("gloo", "cuda", op): "direct" for op in OPS if op != "send_recv"},
    ("gloo", "cuda", "send_recv"): "staged",
}


def route(group, device: torch.device, op: str) -> str:
    key = (str(dist.get_backend(group)), torch.device(device).type, op)
    if key not in ROUTES:
        raise NotImplementedError(f"no route for {key}: the route table has "
                                  f"{sorted(ROUTES)}")
    return ROUTES[key]


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _host(t: torch.Tensor) -> torch.Tensor:
    return _pinned_like(t).copy_(t)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """In place: ``t`` becomes the reduction of every rank's ``t``."""
    if route(group, t.device, "all_reduce") == "direct":
        dist.all_reduce(t, op=op, group=group)
        return
    h = _host(t)
    dist.all_reduce(h, op=op, group=group)
    t.copy_(h)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` (n, ...) gets this rank's block of the sum of every rank's
    ``inp`` (k·n, ...), blocks in group-rank order along dim 0."""
    if route(group, inp.device, "reduce_scatter") == "direct":
        dist.reduce_scatter_tensor(out, inp, group=group)
        return
    h = _pinned_like(out)
    dist.reduce_scatter_tensor(h, _host(inp), group=group)
    out.copy_(h)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` (k·n, ...) gets every rank's ``inp`` (n, ...), in group-rank
    order along dim 0."""
    if route(group, inp.device, "all_gather") == "direct":
        dist.all_gather_into_tensor(out, inp, group=group)
        return
    h = _pinned_like(out)
    dist.all_gather_into_tensor(h, _host(inp), group=group)
    out.copy_(h)


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Block j of ``inp`` (k equal blocks along dim 0) goes to group rank j;
    block j of ``out`` comes from group rank j."""
    if route(group, inp.device, "all_to_all") == "direct":
        dist.all_to_all_single(out, inp, group=group)
        return
    h = _pinned_like(out)
    dist.all_to_all_single(h, _host(inp), group=group)
    out.copy_(h)


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """Post every send ``(tensor, group rank)`` and receive ``(buffer, group
    rank)`` at once and wait for all of them."""
    tensors = [t for t, _ in (*sends, *recvs)]
    staged = route(group, tensors[0].device, "send_recv") == "staged"
    s_bufs = [_host(t) if staged else t.contiguous() for t, _ in sends]
    r_bufs = [_pinned_like(t) if staged else t for t, _ in recvs]
    peer = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    ops = ([dist.P2POp(dist.isend, b, peer(r), group) for b, (_, r) in zip(s_bufs, sends)]
           + [dist.P2POp(dist.irecv, b, peer(r), group) for b, (_, r) in zip(r_bufs, recvs)])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        for b, (t, _) in zip(r_bufs, recvs):
            t.copy_(b)
